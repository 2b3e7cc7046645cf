"""Scoring: corpus BLEU."""
