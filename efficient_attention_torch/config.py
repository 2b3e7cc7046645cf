"""Nested-argparse configuration surface.

Re-implements the reference's signature flag mechanism
(``efficient-attention/efficient_attention/__init__.py:5-39``): each attention
class registers its own CLI flags under a prefix, and parsed values land in a
nested namespace (``--encoder-attn-window-size`` ->
``args.attn_args_encoder.window_size``).  This surface is framework-agnostic
and is preserved exactly so reference users can reuse their launch commands.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict


class NestedNamespace(argparse.Namespace):
    """Namespace that expands dotted attribute names into sub-namespaces
    (reference ``__init__.py:31-39``)."""

    def __setattr__(self, name: str, value: Any) -> None:
        if "." in name:
            group, rest = name.split(".", 1)
            ns = getattr(self, group, NestedNamespace())
            setattr(ns, rest, value)
            self.__dict__[group] = ns
        else:
            self.__dict__[name] = value


def _strip_prefix(text: str, prefix: str) -> str:
    return text[len(prefix):] if text.startswith(prefix) else text


def add_nested_argument(
    parser: argparse.ArgumentParser,
    name: str,
    struct_name: str = "attn_args",
    prefix: str = "",
    **kwargs: Any,
) -> None:
    """``add_argument`` wrapper that routes the parsed value to
    ``<struct_name>.<flag>`` (reference ``__init__.py:22-27``)."""
    if not prefix:
        dest = f"{struct_name}.{name.lstrip('-').replace('-', '_')}"
    else:
        dest = f"{struct_name}.{_strip_prefix(name, '--' + prefix + '-').replace('-', '_')}"
    parser.add_argument(name, dest=dest, **kwargs)


def remove_argument(parser: argparse.ArgumentParser, arg: str) -> None:
    """Drop a previously-registered argument (reference ``__init__.py:5-16``)."""
    for action in parser._actions:
        opts = action.option_strings
        if (opts and opts[0] == arg) or action.dest == arg:
            parser._remove_action(action)
            break
    for group in parser._action_groups:
        for group_action in list(group._group_actions):
            if group_action.dest == arg:
                group._group_actions.remove(group_action)
                return


def namespace_to_dict(ns: argparse.Namespace) -> Dict[str, Any]:
    """Recursively convert a (possibly nested) namespace to plain dicts."""
    out: Dict[str, Any] = {}
    for key, val in vars(ns).items():
        out[key] = namespace_to_dict(val) if isinstance(val, argparse.Namespace) else val
    return out
