"""YAML config composition for the training CLIs (``--config``).

The port's own copy of ``efficient_attention_tpu/config_yaml.py`` (the
hydra-path analogue of the reference's ``fairseq/dataclass/`` stack, with
pyyaml and the nested-argparse surface):

  * ``defaults:`` lists other YAML files (relative to the including file),
    merged in order, later files and the including file winning; only a
    true include cycle raises;
  * flat keys map onto argparse dests (``lr: 5e-4`` -> ``args.lr``) and are
    validated against the parser (unknown keys raise, values pass through
    the action's ``type``/``choices``);
  * nested mappings map onto the nested attention namespaces
    (``attn_args_decoder: {window_size: 8}`` ->
    ``args.attn_args_decoder.window_size``);
  * explicit command-line flags override YAML values; explicitness is
    decided by argparse itself (a re-parse with suppressed defaults).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional


def load_yaml_config(path: str,
                     _chain: Optional[tuple] = None) -> Dict[str, Any]:
    """Load a YAML config, recursively composing its ``defaults:`` list.

    ``_chain`` is the current include *path* (not a global visited set),
    so diamond composition is allowed and only real cycles raise.
    """
    import yaml

    path = os.path.abspath(path)
    _chain = _chain or ()
    if path in _chain:
        raise ValueError(f"circular config include: {path}")
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} must be a mapping")
    merged: Dict[str, Any] = {}
    for inc in cfg.pop("defaults", []) or []:
        inc_path = inc if os.path.isabs(inc) else os.path.join(
            os.path.dirname(path), inc)
        sub = load_yaml_config(inc_path, _chain + (path,))
        for key, val in sub.items():
            if isinstance(val, dict) and isinstance(merged.get(key), dict):
                merged[key].update(val)
            else:
                merged[key] = val
    for key, val in cfg.items():
        if isinstance(val, dict) and isinstance(merged.get(key), dict):
            merged[key].update(val)
        else:
            merged[key] = val
    return merged


def _explicit_dests(parser: argparse.ArgumentParser,
                    argv: List[str]) -> set:
    """Dests of options actually present on the command line (these beat
    YAML).  Implemented by re-parsing with every default suppressed, so
    argparse itself decides — ``--flag value``, ``--flag=value``, and
    prefix abbreviations are all recognized."""
    saved = [(a, a.default) for a in parser._actions]
    for a in parser._actions:
        a.default = argparse.SUPPRESS
    try:
        ns, _ = parser.parse_known_args(argv)
    finally:
        for a, d in saved:
            a.default = d
    return set(vars(ns).keys())


def _cli_tokens(argv: Optional[List[str]]) -> List[str]:
    return list(sys.argv[1:] if argv is None else argv)


def preparse_overrides(parser: argparse.ArgumentParser,
                       argv: Optional[List[str]],
                       dests: List[str]) -> Dict[str, Any]:
    """Resolve the class-selecting keys (attn names / model) BEFORE the
    second-pass flag registration: explicit CLI > YAML > parsed default.

    Shared by the train CLIs so the precedence logic exists once.
    """
    tokens = _cli_tokens(argv)
    known, _ = parser.parse_known_args(tokens)
    resolved = {d: getattr(known, d) for d in dests}
    cfg_path = getattr(known, "config", None)
    if cfg_path:
        cfg = load_yaml_config(cfg_path)
        explicit = _explicit_dests(parser, tokens)
        actions = {a.dest: a for a in parser._actions}
        for d in dests:
            if d not in explicit and d in cfg:
                resolved[d] = _coerce(actions.get(d), cfg[d], d)
    return resolved


def _coerce(action: Optional[argparse.Action], val: Any, key: str) -> Any:
    """Validate/coerce a YAML value like argparse would the CLI string."""
    if action is None:
        raise ValueError(
            f"unknown config key '{key}' (no matching CLI option)")
    if isinstance(val, str) and action.type is not None:
        val = action.type(val)
    if action.choices is not None and val not in action.choices:
        raise ValueError(
            f"config key '{key}': {val!r} not in {list(action.choices)}")
    return val


def apply_yaml_config(args: argparse.Namespace,
                      parser: argparse.ArgumentParser,
                      argv: Optional[List[str]]) -> argparse.Namespace:
    """Apply ``args.config`` (if set) under explicit-CLI-wins semantics."""
    cfg_path = getattr(args, "config", None)
    if not cfg_path:
        return args
    cfg = load_yaml_config(cfg_path)
    explicit = _explicit_dests(parser, _cli_tokens(argv))
    actions = {a.dest: a for a in parser._actions}
    # flat keys may be dash- or underscore-spelled; the sibling-class lookup
    # below must see the normalized spelling either way
    cfg_norm = {k.replace("-", "_"): v for k, v in cfg.items()}
    for key, val in cfg.items():
        dest = key.replace("-", "_")
        if dest == "task":
            # reserved routing key consumed by cli/hydra_train.py
            continue
        if isinstance(val, dict):
            # a nested group configures the class its sibling *name* key
            # selects; if the CLI overrode that class, the group's args
            # belong to a class that is no longer registered — drop them
            # (hydra swaps the whole config group likewise)
            name_dest = {"attn_specific_args": "attn_name"}.get(
                dest, dest.replace("attn_args_", "attn_name_"))
            cfg_name = cfg_norm.get(name_dest)
            if (cfg_name is not None
                    and getattr(args, name_dest, cfg_name) != cfg_name):
                continue
            # nested attention-args group: merge into the sub-namespace
            sub = getattr(args, dest, None)
            if sub is None:
                sub = argparse.Namespace()
                setattr(args, dest, sub)
            for k2, v2 in val.items():
                d2 = k2.replace("-", "_")
                full = f"{dest}.{d2}"
                if full not in explicit:
                    setattr(sub, d2, _coerce(actions.get(full), v2, full))
        elif dest not in explicit:
            setattr(args, dest, _coerce(actions.get(dest), val, key))
    return args


def add_config_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--config", default=None, metavar="YAML",
        help="YAML config file (composed via its defaults: list); "
             "explicit CLI flags override its values")
