"""Generation: beam search over a decode state."""
