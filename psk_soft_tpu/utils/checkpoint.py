"""Checkpoint / resume for demod carry state.

The reference has no checkpointing: its state lives in in-memory deques and a
restart re-converges only after the numAvg*sps warm-up
(cpp/psk_soft.cpp:377,457; SURVEY.md section 5).  Here the entire demod state
is an explicit pytree, so checkpoint = serialize the leaves; resume = pass
them back in -- restart-from-block is exact, not a re-convergence.

Format: ``.npz`` with float32 planes for complex leaves plus a JSON header
recording the state class and the DemodConfig.  Round 5: NESTED states
(the seam chain's ChainState = FullState + SeamTailState, the front
chain's FrontChainState incl. an optional AgcState) serialize
recursively with dotted array keys; pre-r5 flat checkpoints still load.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DemodConfig

_STATE_REGISTRY = {}


def _registry():
    if not _STATE_REGISTRY:
        from ..state import DemodState
        from ..models.blockpsk import FFState, SymbolBackendState
        from ..models.chain import (ChainState, FrontChainState,
                                    FrontState, SeamTailState)
        from ..models.full import FullState
        from ..ops.agc import AgcState
        from ..ops.equalizer import EqState
        from ..ops.fec import ViterbiStreamState
        for cls in (DemodState, FFState, SymbolBackendState, FullState, EqState, ViterbiStreamState, AgcState,
                    SeamTailState, ChainState, FrontState,
                    FrontChainState):
            _STATE_REGISTRY[cls.__name__] = cls
    return _STATE_REGISTRY


def _is_state(x) -> bool:
    return hasattr(type(x), "_fields") and type(x).__name__ in _registry()


def _serialize(state, arrays: dict, prefix: str = "") -> dict:
    """Recursively flatten a (possibly nested) state NamedTuple into
    ``arrays`` with dotted keys; returns the structure descriptor."""
    desc = {"class": type(state).__name__, "fields": {}}
    for name, leaf in zip(type(state)._fields, state):
        key = f"{prefix}{name}"
        if leaf is None:
            desc["fields"][name] = {"kind": "none"}
        elif _is_state(leaf):
            child = _serialize(leaf, arrays, key + ".")
            child["kind"] = "state"
            desc["fields"][name] = child
        else:
            leaf = np.asarray(leaf)
            if np.iscomplexobj(leaf):
                arrays[f"{key}__re"] = np.asarray(leaf.real, np.float32)
                arrays[f"{key}__im"] = np.asarray(leaf.imag, np.float32)
                desc["fields"][name] = {"kind": "complex"}
            else:
                arrays[key] = leaf
                desc["fields"][name] = {"kind": "array"}
    return desc


def _deserialize(desc: dict, z, prefix: str = ""):
    cls = _registry()[desc["class"]]
    leaves = []
    for name, fd in desc["fields"].items():
        key = f"{prefix}{name}"
        kind = fd["kind"]
        if kind == "none":
            leaves.append(None)
        elif kind == "state":
            leaves.append(_deserialize(fd, z, key + "."))
        elif kind == "complex":
            re = z[f"{key}__re"]
            im = z[f"{key}__im"]
            out = np.empty(re.shape, np.complex64)
            out.real = re
            out.imag = im
            leaves.append(jnp.asarray(out))
        else:
            leaves.append(jnp.asarray(z[key]))
    return cls(*leaves)


def save_state(path: str, state, cfg: DemodConfig, extra: dict | None = None):
    """Serialize a carry state + its config to ``path`` (.npz).

    Handles flat AND nested state NamedTuples (ChainState,
    FrontChainState, ...); ``None`` fields (e.g. a disabled AGC) round-
    trip as None.
    """
    host = jax.device_get(state)
    arrays = {}
    desc = _serialize(host, arrays)
    header = {
        "state_desc": desc,
        "state_class": type(state).__name__,   # legacy readers' key
        "config": dataclasses.asdict(cfg),
        "extra": extra or {},
    }
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), np.uint8)
    np.savez(path, **arrays)


def load_state(path: str):
    """Returns (state, DemodConfig, extra); reads both the r5 nested
    format and pre-r5 flat checkpoints."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if "state_desc" in header:
            state = _deserialize(header["state_desc"], z)
        else:                      # pre-r5 flat format
            cls = _registry()[header["state_class"]]
            leaves = []
            for name in header["fields"]:
                if name in header["complex_fields"]:
                    re = z[f"{name}__re"]
                    im = z[f"{name}__im"]
                    out = np.empty(re.shape, np.complex64)
                    out.real = re
                    out.imag = im
                    leaves.append(jnp.asarray(out))
                else:
                    leaves.append(jnp.asarray(z[name]))
            state = cls(*leaves)
    cfg = DemodConfig(**header["config"])
    return state, cfg, header["extra"]
