"""The environment knobs the port reads: the ``PADDLE_TPU_SERVE_*`` rows
of the serving engine, the training health policy, the TP overlap
mode of ``fusion/overlap_mm.py`` and the datasets' rows
(``PADDLE_TPU_DATA_HOME``, ``PADDLE_TPU_SYNTH_SAMPLES``).

The port keeps its own copy of the rows it needs, with the same names,
types, defaults and parse rules as the JAX package's registry, so one
environment configures either engine the same way:

* an unset or empty value yields the default, and so does a malformed
  numeric value (a typo'd knob degrades to documented behaviour);
* a call site may pass its own default without redeclaring the knob.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

__all__ = ["Knob", "KNOBS", "get_str", "get_int"]


class Knob(NamedTuple):
    name: str
    type: str           # str | int
    default: Any        # documented default; None = unset/derived
    doc: str


def _k(name: str, type: str, default: Any, doc: str) -> Knob:
    return Knob("PADDLE_TPU_" + name, type, default, doc)


_ALL = (
    _k("SERVE_SLOTS", "int", 8,
       "Max concurrent decode slots per serving engine."),
    _k("SERVE_BLOCK_SIZE", "int", 16, "KV page size in token slots."),
    _k("SERVE_NUM_BLOCKS", "int", 512,
       "KV pool size in pages (shared across layers)."),
    _k("SERVE_PREFILL_CHUNK", "int", 32,
       "Prefill tokens admitted per engine step."),
    _k("SERVE_RAGGED", "str", "auto",
       "Single-dispatch ragged step: auto|on|off "
       "(off restores the two-program decode+prefill layout)."),
    _k("SERVE_TOKEN_BUDGET", "int", None,
       "Token axis of the ragged step "
       "(default: SERVE_SLOTS + SERVE_PREFILL_CHUNK)."),
    _k("HEALTH", "str", "off",
       "Non-finite grad policy: off|warn|skip|raise."),
    _k("TP_OVERLAP", "str", "auto",
       "TP comm/compute overlap: auto|on|off|pallas."),
    _k("DATA_HOME", "str", "~/.cache/paddle_tpu", "Dataset cache root."),
    _k("SYNTH_SAMPLES", "int", 32,
       "Synthetic-fallback dataset size (datasets override the "
       "default per split)."),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}

_MISSING = object()


def _declared(name: str, want: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError("undeclared env knob %r" % (name,))
    if k.type != want:
        raise TypeError("knob %s is declared %s, read as %s"
                        % (name, k.type, want))
    return k


def get_str(name: str, default: Any = _MISSING) -> Optional[str]:
    k = _declared(name, "str")
    v = os.environ.get(name)
    if v is None or not v.strip():
        return k.default if default is _MISSING else default
    return v


def get_int(name: str, default: Any = _MISSING) -> Optional[int]:
    k = _declared(name, "int")
    v = os.environ.get(name)
    d = k.default if default is _MISSING else default
    if v is None or not v.strip():
        return d
    try:
        return int(v)
    except ValueError:
        return d
