"""Minimal yacs-compatible configuration node — the port's own copy of
``stnerf_tpu/config/node.py`` (the port imports nothing of the JAX package).

The reference uses a yacs ``CfgNode`` global singleton (ref:
config/__init__.py:7). yacs is not available in this environment, so this is
a small, dependency-free implementation of the subset of the yacs API the
framework (and the reference's demo scripts) use: attribute access,
``merge_from_file`` (YAML), ``merge_from_other_cfg``, ``merge_from_list``,
``freeze``/``defrost``, ``clone`` and pretty-printing.

Unlike the reference we do not encourage the mutable global singleton style;
``stnerf_tpu_torch.config.get_cfg()`` returns a fresh copy of the defaults.
"""

from __future__ import annotations

import copy
from typing import Any

import yaml

_FROZEN = "__cfg_frozen__"


class CfgNode(dict):
    """A dict with attribute access, freezing and YAML merging."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute <-> item access -------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {name!r}")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise KeyError(f"CfgNode is frozen; cannot set {name!r}")
        super().__setitem__(name, value)

    # -- pickling ---------------------------------------------------------
    # dict subclass pickling restores items through __setitem__ BEFORE
    # instance state, so the frozen flag must not be assumed present
    # (workers unpickle configs in multiprocessing pregeneration).
    def __reduce__(self):
        return (_unpickle_cfg, (dict(self), self.is_frozen()))

    # -- freezing -------------------------------------------------------
    def is_frozen(self) -> bool:
        try:
            return object.__getattribute__(self, _FROZEN)
        except AttributeError:
            return False

    def freeze(self) -> "CfgNode":
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    # -- merging ----------------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def merge_from_other_cfg(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other_cfg(v)
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else _coerce(self.get(k), v)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other_cfg(data)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node[parts[-1]] = _coerce(node.get(parts[-1]), value)

    def dump(self) -> str:
        def plain(n):
            return {k: plain(v) if isinstance(v, CfgNode) else v for k, v in n.items()}

        return yaml.safe_dump(plain(self), sort_keys=False)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfgNode({self.dump()})"


def _unpickle_cfg(items: dict, frozen: bool) -> "CfgNode":
    node = CfgNode(items)
    if frozen:
        node.freeze()
    return node


def _coerce(old: Any, new: Any) -> Any:
    """Coerce YAML-parsed values toward the default's type (yacs behavior).

    Handles the reference configs writing ``BOARDER_WEIGHT: 1e10`` (parsed by
    YAML as the *string* "1e10") against a float default.
    """
    if old is None:
        return new
    if isinstance(old, float) and isinstance(new, (int, str)):
        return float(new)
    if isinstance(old, int) and not isinstance(old, bool) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    return new
