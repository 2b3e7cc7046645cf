"""Named architecture presets: the ``--arch`` registry.

Counterpart of ``efficient_attention_tpu/models/archs.py`` (fairseq
``register_model_architecture``, ``transformer_legacy.py:225-330`` and
``transformer_lm.py:330-500``): a preset dict per name, applied to exactly
the dests the user did not pin on the command line or in the YAML config
(explicit > config > arch > parser default).  MT dims map onto the MT CLI's
flags (one ``encoder-embed-dim`` feeds both sides of the model).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# --- MT (``fairseq/models/transformer/transformer_legacy.py``) ---
_MT_BIG = {
    "encoder_embed_dim": 1024,
    "encoder_ffn_embed_dim": 4096,
    "encoder_attention_heads": 16,
    "dropout": 0.3,
}
MT_ARCHS: Dict[str, Dict[str, Any]] = {
    # base (``transformer_legacy.py:238``): the CLI defaults
    "transformer": {},
    "transformer_wmt_en_de": {},
    # ``transformer_legacy.py:225-234``
    "transformer_iwslt_de_en": {
        "encoder_embed_dim": 512,
        "encoder_ffn_embed_dim": 1024,
        "encoder_attention_heads": 4,
        "encoder_layers": 6,
        "decoder_layers": 6,
    },
    # ``transformer_legacy.py:309-318``
    "transformer_vaswani_wmt_en_de_big": dict(_MT_BIG),
    "transformer_wmt_en_de_big": dict(_MT_BIG),
    # ``transformer_legacy.py:322-323`` (big with dropout 0.1)
    "transformer_vaswani_wmt_en_fr_big": {**_MT_BIG, "dropout": 0.1},
}

# --- LM (``fairseq/models/transformer_lm.py``) ---
_LM_WIKI103 = {
    # ``transformer_lm_baevski_wiki103`` (:408-426) + transformer_lm_big: the
    # published checkpoint configuration
    "decoder_embed_dim": 1024,
    "decoder_ffn_embed_dim": 4096,
    "decoder_layers": 16,
    "decoder_attention_heads": 8,
    "dropout": 0.3,
    "adaptive_input": True,
    "tie_adaptive_weights": True,
    "adaptive_cutoffs": "20000,60000",
    "no_decoder_final_norm": True,
    "criterion": "adaptive_loss",
}
# the train_lm parser defaults are the wiki103 recipe (adaptive loss and
# cutoffs); every other arch resets them to fairseq's full-softmax base
_LM_PLAIN_SOFTMAX = {
    "criterion": "cross_entropy",
    "adaptive_input": False,
    "tie_adaptive_weights": False,
}


def _plain(embed, ffn, layers, heads, **extra):
    return {**_LM_PLAIN_SOFTMAX, "decoder_embed_dim": embed,
            "decoder_ffn_embed_dim": ffn, "decoder_layers": layers,
            "decoder_attention_heads": heads, **extra}


LM_ARCHS: Dict[str, Dict[str, Any]] = {
    "transformer_lm": _plain(512, 2048, 6, 8),            # :330-346
    "transformer_lm_big": _plain(1024, 4096, 12, 16),     # :398-402
    "transformer_lm_wiki103": dict(_LM_WIKI103),
    "transformer_lm_baevski_wiki103": dict(_LM_WIKI103),
    "transformer_lm_gpt": _plain(768, 3072, 12, 12, activation_fn="gelu"),
    "transformer_lm_gpt2_tiny": _plain(64, 64, 2, 1, activation_fn="gelu"),
    "transformer_lm_gpt2_small": _plain(1024, 4096, 24, 16, activation_fn="gelu"),
    "transformer_lm_gpt2_medium": _plain(1280, 5120, 36, 20, activation_fn="gelu"),
    "transformer_lm_gpt2_big": _plain(1600, 6400, 48, 25, activation_fn="gelu"),
}


def apply_arch(args, parser, argv: Optional[list],
               table: Dict[str, Dict[str, Any]]):
    """Fill preset values for dests the user did not pin (CLI or YAML)."""
    name = getattr(args, "arch", None)
    if not name:
        return args
    preset = table.get(name)
    if preset is None:
        raise ValueError(f"unknown --arch {name!r} (registered: {sorted(table)})")
    from efficient_attention_torch.config_yaml import (
        _cli_tokens,
        _explicit_dests,
        load_yaml_config,
    )

    explicit = _explicit_dests(parser, _cli_tokens(argv))
    yaml_keys = set()
    if getattr(args, "config", None):
        yaml_keys = {k.replace("-", "_") for k in load_yaml_config(args.config)}
    for dest, val in preset.items():
        if dest not in explicit and dest not in yaml_keys:
            setattr(args, dest, val)
    return args
