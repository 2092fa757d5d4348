"""Parthenon-style input deck parser.

Accepts the reference's ``inputs/*.in`` decks verbatim: INI-like ``<block>``
sections, ``key = value  # comment`` lines, and command-line overrides of the
form ``block/key=value`` (the convention used pervasively by the reference
test harness, see AthenaPK ``tst/regression/test_suites/convergence/
convergence.py:97-109``).

Typed getters mirror the Parthenon ``ParameterInput`` API surface as used by
AthenaPK (``GetReal/GetInteger/GetString/GetBoolean`` and the ``GetOrAdd*``
variants which record defaults back into the deck so they appear in outputs).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Union


_BLOCK_RE = re.compile(r"^<\s*([^>]+?)\s*>$")

_TRUE_STRINGS = {"true", "1", "on", "yes"}
_FALSE_STRINGS = {"false", "0", "off", "no"}


class ParameterInput:
    """Nested ``{block: {key: raw-string-value}}`` store with typed access."""

    def __init__(self) -> None:
        self.blocks: "OrderedDict[str, OrderedDict[str, str]]" = OrderedDict()

    # ------------------------------------------------------------------ parse
    @classmethod
    def from_file(cls, path: str, overrides: Optional[Iterable[str]] = None
                  ) -> "ParameterInput":
        with open(path, "r") as fh:
            pin = cls.from_string(fh.read())
        if overrides:
            pin.apply_overrides(overrides)
        return pin

    @classmethod
    def from_string(cls, text: str, overrides: Optional[Iterable[str]] = None
                    ) -> "ParameterInput":
        pin = cls()
        current = None
        for raw_line in text.splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line:
                continue
            m = _BLOCK_RE.match(line)
            if m:
                name = m.group(1)
                current = pin.blocks.setdefault(name, OrderedDict())
                continue
            if "=" in line:
                key, _, value = line.partition("=")
                key = key.strip()
                value = value.strip()
                if current is None:
                    raise ValueError(f"parameter '{key}' outside of any <block>")
                # Later duplicate assignments override earlier ones, matching
                # the reference decks (e.g. sod.in re-assigns ix2_bc).
                current[key] = value
        if overrides:
            pin.apply_overrides(overrides)
        return pin

    def apply_overrides(self, overrides: Iterable[str]) -> None:
        """Apply ``block/key=value`` CLI-style overrides."""
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"malformed override '{ov}' (need block/key=value)")
            lhs, _, value = ov.partition("=")
            if "/" not in lhs:
                raise ValueError(f"malformed override '{ov}' (need block/key=value)")
            block, _, key = lhs.rpartition("/")
            self.blocks.setdefault(block, OrderedDict())[key.strip()] = value.strip()

    # ------------------------------------------------------------------ query
    def has_block(self, block: str) -> bool:
        return block in self.blocks

    def has(self, block: str, key: str) -> bool:
        return block in self.blocks and key in self.blocks[block]

    def _get_raw(self, block: str, key: str) -> str:
        try:
            return self.blocks[block][key]
        except KeyError:
            raise KeyError(f"missing required parameter <{block}> {key}") from None

    def set(self, block: str, key: str, value: Union[str, int, float, bool]) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self.blocks.setdefault(block, OrderedDict())[key] = str(value)

    # Typed getters ----------------------------------------------------------
    def get_string(self, block: str, key: str) -> str:
        return self._get_raw(block, key)

    def get_integer(self, block: str, key: str) -> int:
        return int(self._get_raw(block, key))

    def get_real(self, block: str, key: str) -> float:
        return float(self._get_raw(block, key))

    def get_bool(self, block: str, key: str) -> bool:
        raw = self._get_raw(block, key).lower()
        if raw in _TRUE_STRINGS:
            return True
        if raw in _FALSE_STRINGS:
            return False
        raise ValueError(f"<{block}> {key} = '{raw}' is not a boolean")

    # GetOrAdd* record the default back into the deck (Parthenon semantics).
    def get_or_add_string(self, block: str, key: str, default: str) -> str:
        if not self.has(block, key):
            self.set(block, key, default)
        return self.get_string(block, key)

    def get_or_add_integer(self, block: str, key: str, default: int) -> int:
        if not self.has(block, key):
            self.set(block, key, default)
        return self.get_integer(block, key)

    def get_or_add_real(self, block: str, key: str, default: float) -> float:
        if not self.has(block, key):
            self.set(block, key, default)
        return self.get_real(block, key)

    def get_or_add_bool(self, block: str, key: str, default: bool) -> bool:
        if not self.has(block, key):
            self.set(block, key, default)
        return self.get_bool(block, key)

    # ------------------------------------------------------------------ dump
    def output_blocks(self) -> List[str]:
        """Names of ``parthenon/output*`` blocks, sorted."""
        out = [b for b in self.blocks if re.match(r"parthenon/output\d+$", b)]
        return sorted(out)

    def to_string(self) -> str:
        lines = []
        for block, kv in self.blocks.items():
            lines.append(f"<{block}>")
            for k, v in kv.items():
                lines.append(f"{k} = {v}")
            lines.append("")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        nb = len(self.blocks)
        return f"ParameterInput({nb} blocks)"
