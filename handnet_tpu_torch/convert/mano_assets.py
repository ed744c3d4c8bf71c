"""Chumpy-free MANO pkl -> npz converter.

The official MANO_{LEFT,RIGHT}.pkl files serialize chumpy objects (a dead
Python-2-era autodiff library the reference drags in through
mano/webuser/smpl_handpca_wrapper_HAND_only.py:ready_arguments). We unpickle
them WITHOUT chumpy by installing stub classes that capture the pickled state,
then extract the underlying numpy arrays. Run once offline:

    python -m handnet_tpu_torch.convert.mano_assets MANO_RIGHT.pkl mano_right.npz

The npz feeds models/mano.py (ManoAssets.load), the demo's --mano-assets
and train_pose2mesh's --mano-npz. The licensed model files are never
committed — only this converter is (SURVEY §7 hard-part 4).

The port's copy of ``handnet_tpu/convert/mano_assets.py`` (numpy only), with
one difference: :func:`load_mano_pkl` removes the stub modules it installed
once the pickle is read. The JAX converter leaves them in ``sys.modules``,
where their ``__getattr__`` answers every name (``__file__`` included) and
breaks any later walk of ``sys.modules`` through ``inspect``, such as the
one torch makes when it first imports ``torch._dynamo``. A real chumpy, or
stubs that were there before the call, are left as they were.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Any

import numpy as np


class _ChumpyStub:
    """Absorbs any pickled chumpy object; keeps its __dict__ for extraction."""

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


_STUB_MODULES = ("chumpy", "chumpy.ch", "chumpy.ch_ops", "chumpy.reordering")


def _install_chumpy_stubs() -> list:
    """Register fake chumpy modules so pickle can resolve its classes;
    returns the names of the modules it added."""
    added = []
    for mod_name in _STUB_MODULES:
        if mod_name in sys.modules:
            continue  # a real chumpy, or stubs already there; use them
        mod = types.ModuleType(mod_name)
        mod._handnet_stub = True

        def _getattr(name, _mod=mod, _mod_name=mod_name):
            cls = type(name, (_ChumpyStub,),
                       {"__module__": _mod_name, "__qualname__": name})
            setattr(_mod, name, cls)
            return cls

        mod.__getattr__ = _getattr
        sys.modules[mod_name] = mod
        added.append(mod_name)
    return added


def _to_numpy(obj: Any) -> Any:
    """Recursively reduce chumpy stubs / scipy sparse to plain numpy."""
    if isinstance(obj, np.ndarray):
        return obj
    if hasattr(obj, "toarray"):  # scipy sparse (J_regressor)
        return np.asarray(obj.toarray())
    if isinstance(obj, _ChumpyStub) or hasattr(obj, "__dict__"):
        d = getattr(obj, "__dict__", {})
        # chumpy stores the concrete array under 'x' (ch.array) — recurse
        for key in ("x", "a", "_data"):
            if key in d:
                return _to_numpy(d[key])
        # dr-wrt caches etc: find the first ndarray value
        for v in d.values():
            r = _to_numpy(v)
            if isinstance(r, np.ndarray):
                return r
    return obj


def load_mano_pkl(path: str) -> dict:
    """Unpickle a MANO model file without chumpy; values as numpy arrays.
    The stub modules it installs are gone from ``sys.modules`` afterwards."""
    added = _install_chumpy_stubs()
    try:
        with open(path, "rb") as f:
            dd = pickle.load(f, encoding="latin1")
    finally:
        for mod_name in added:
            del sys.modules[mod_name]
    out = {}
    for key, value in dd.items():
        reduced = _to_numpy(value)
        out[key] = reduced
    return out


def convert(pkl_path: str, npz_path: str) -> dict:
    """Convert MANO pkl -> the npz layout ManoAssets.load expects."""
    dd = load_mano_pkl(pkl_path)
    arrays = {
        "v_template": np.asarray(dd["v_template"], np.float64),
        "shapedirs": np.asarray(dd["shapedirs"], np.float64),
        "posedirs": np.asarray(dd["posedirs"], np.float64),
        "J_regressor": np.asarray(_to_numpy(dd["J_regressor"]), np.float64),
        "weights": np.asarray(dd["weights"], np.float64),
        "hands_components": np.asarray(dd["hands_components"], np.float64),
        "hands_mean": np.asarray(dd["hands_mean"], np.float64),
        "faces": np.asarray(dd["f"], np.int64),
        "kintree_table": np.asarray(dd["kintree_table"], np.int64),
    }
    np.savez(npz_path, **arrays)
    return arrays


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print("usage: python -m handnet_tpu_torch.convert.mano_assets "
              "MANO_RIGHT.pkl mano_right.npz", file=sys.stderr)
        sys.exit(1)
    convert(sys.argv[1], sys.argv[2])
    print(f"wrote {sys.argv[2]}")
