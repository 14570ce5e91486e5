"""Minimal yacs-compatible configuration system.

The reference framework configures everything through a frozen yacs ``CfgNode``
tree merged from YAML files plus ``KEY VALUE`` CLI override lists
(cf. reference ``mopa/common/config/base.py`` and ``mopa/train/train_xmuda_mopa.py:694-697``).
yacs is not available in this environment, so this module provides a small,
behaviour-compatible implementation: attribute access, ``merge_from_file``,
``merge_from_list``, ``freeze``/``defrost``, ``clone`` and yacs' type-coercion
rules (including the quirk that YAML strings like ``"(80000, 90000)"`` written
with round brackets are parsed into Python tuples).

Copy of ``mopa_tpu/common/config.py`` for the PyTorch package. ``yaml`` is
imported only inside :meth:`CfgNode.merge_from_file` and :meth:`CfgNode.dump`,
so a config built in code needs no PyYAML.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A dict subclass with attribute access and freezing, like yacs.CfgNode."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            elif isinstance(v, CfgNode):
                v = v.clone()
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(name, value)
            )
        self[name] = value

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(name, value)
            )
        dict.__setitem__(self, name, value)

    # -- freezing -----------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- cloning / merging ----------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                dict.__setitem__(out, k, v.clone())
            else:
                dict.__setitem__(out, k, copy.deepcopy(v))
        return out

    def merge_from_file(self, cfg_filename: str) -> None:
        import yaml

        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        loaded = CfgNode(_decode_tree(loaded or {}))
        _merge_a_into_b(loaded, self, key_path=[])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self, key_path=[])

    def merge_from_list(self, cfg_list: List[str]) -> None:
        assert len(cfg_list) % 2 == 0, (
            "Override list has odd length: {}".format(cfg_list)
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            key_parts = full_key.split(".")
            for sub_key in key_parts[:-1]:
                assert sub_key in d, "Non-existent key: {}".format(full_key)
                d = d[sub_key]
            sub_key = key_parts[-1]
            assert sub_key in d, "Non-existent key: {}".format(full_key)
            value = _decode_value(v)
            value = _check_and_coerce(value, d[sub_key], full_key)
            d[sub_key] = value

    def dump(self) -> str:
        import yaml

        def to_plain(node):
            if isinstance(node, CfgNode):
                return {k: to_plain(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        return yaml.safe_dump(to_plain(self), default_flow_style=False)

    def __str__(self) -> str:
        def _indent(s, num_spaces):
            lines = s.split("\n")
            first = lines.pop(0)
            lines = [(" " * num_spaces) + line for line in lines]
            return "\n".join([first] + lines)

        r = ""
        for k, v in sorted(self.items()):
            sep = "\n" if isinstance(v, CfgNode) else " "
            attr_str = "{}:{}{}".format(str(k), sep, str(v))
            r += _indent(attr_str, 2) + "\n"
        return r.rstrip("\n")

    def __repr__(self) -> str:
        return "{}({})".format(self.__class__.__name__, super().__repr__())


def _decode_value(value: Any) -> Any:
    """Decode a raw YAML/CLI value like yacs: strings that parse as Python
    literals (most importantly ``"(1, 2)"`` tuples) become literals."""
    if not isinstance(value, str):
        return value
    try:
        value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    return value


def _decode_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _decode_tree(v) for k, v in node.items()}
    return _decode_value(node)


def _check_and_coerce(replacement: Any, original: Any, full_key: str) -> Any:
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None or replacement is None:
        return replacement
    # yacs casting rules
    casts = [(tuple, list), (list, tuple), (int, float)]
    for src, dst in casts:
        if replacement_type == src and original_type == dst:
            return dst(replacement)
    raise ValueError(
        "Type mismatch ({} vs. {}) for key {} with values ({} vs. {})".format(
            original_type, replacement_type, full_key, original, replacement
        )
    )


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_path: List[str]) -> None:
    for k, v_ in a.items():
        full_key = ".".join(key_path + [str(k)])
        if k not in b:
            raise KeyError("Non-existent config key: {}".format(full_key))
        v = v_
        if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
            _merge_a_into_b(v, b[k], key_path + [str(k)])
        else:
            if isinstance(b[k], CfgNode):
                raise ValueError(
                    "Cannot overwrite config node {} with a value".format(full_key)
                )
            v = _check_and_coerce(v, b[k], full_key)
            b[k] = v


def purge_cfg(cfg: CfgNode) -> None:
    """Purge sibling CfgNodes whose name does not match the local ``TYPE``
    key, so that dumped configs stay readable (reference
    ``mopa/common/config/__init__.py:4-17``). A child that carries its own
    ``TYPE`` (``OPTIMIZER.MODEL_2D``) stays; an empty ``TYPE`` purges
    nothing."""
    target_key = cfg.get("TYPE", None)
    removed_keys = []
    for k, v in cfg.items():
        if isinstance(v, CfgNode):
            if target_key and (k != target_key) and ("TYPE" not in v):
                removed_keys.append(k)
            else:
                purge_cfg(v)
    for k in removed_keys:
        del cfg[k]
