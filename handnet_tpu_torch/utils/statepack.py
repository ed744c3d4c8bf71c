"""Serialize trained (FCOS, A2J) stage states for cross-tool reuse.

The port's copy of ``handnet_tpu/utils/statepack.py``: one file holds the
params and batch statistics of both stages, under the flax tree's keys,
with the config fields that rebuild the same models, in flax's
``msgpack_serialize`` format (``utils/msgpack_lite.py``; no pickle, and an
architecture mismatch fails loudly on field names at rebuild time). A file
the JAX package writes reads here, and one written here reads there.

:func:`save_trained_states` takes the port's ``TrainState``\\ s (or bare
models) and writes each model's state dict as the flax tree
(``train/checkpoints.py``'s ``_VARIABLES`` map: FCOS, A2J, Faster R-CNN
or Pose2Mesh). :func:`load_trained_states` returns the JAX package's
5-tuple: each stage's ``{"params", "batch_stats"}`` as numpy trees, its
config, and the ``synth`` dict; ``convert/from_flax.py``
(``fcos_state_dict_from_flax``, ``a2j_state_dict_from_flax``) turns the
trees into state dicts for the port's modules.

Not a checkpoint format: ``train/checkpoints.py`` owns training
checkpoints; this is a lightweight tool-to-tool handoff.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from handnet_tpu_torch.config import A2JConfig, FCOSConfig
from handnet_tpu_torch.utils.msgpack_lite import msgpack_restore, msgpack_serialize


def _cfg_dict(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    # msgpack has no tuple type; round-trip via lists (rebuild re-tuples)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}


def _cfg_from(cls, d: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"packed config field {k!r} unknown to "
                           f"{cls.__name__} — version mismatch?")
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def _variables(state) -> Dict[str, dict]:
    """A ``TrainState``'s (or a model's) ``{"params", "batch_stats"}`` as
    the flax tree, numpy leaves."""
    from handnet_tpu_torch.train.checkpoints import _VARIABLES

    model = getattr(state, "model", state)
    for cls, variables_of in _VARIABLES:
        if isinstance(model, cls):
            tree = variables_of(model.state_dict())
            return {"params": tree.get("params", {}),
                    "batch_stats": tree.get("batch_stats", {})}
    raise TypeError(f"save_trained_states: {type(model).__name__} is not a trainable model "
                    "of the port")


def save_trained_states(path: str, fstate, fcfg: FCOSConfig,
                        astate, acfg: A2JConfig,
                        synth: Dict[str, Any] | None = None) -> None:
    """Pack two trained TrainStates (params + batch_stats only — optimizer
    state is training-internal) with their model configs."""
    f_vars, a_vars = _variables(fstate), _variables(astate)
    payload = {
        "fcos": {**f_vars, "cfg": _cfg_dict(fcfg)},
        "a2j": {**a_vars, "cfg": _cfg_dict(acfg)},
        "synth": dict(synth or {}),
    }
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))


def load_trained_states(path: str) -> Tuple[dict, FCOSConfig, dict,
                                            A2JConfig, Dict[str, Any]]:
    """Returns (fcos_variables, fcos_cfg, a2j_variables, a2j_cfg, synth_meta)
    where each variables dict holds {'params', 'batch_stats'}."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    fcfg = _cfg_from(FCOSConfig, payload["fcos"]["cfg"])
    acfg = _cfg_from(A2JConfig, payload["a2j"]["cfg"])
    f_vars = {"params": payload["fcos"]["params"],
              "batch_stats": payload["fcos"]["batch_stats"]}
    a_vars = {"params": payload["a2j"]["params"],
              "batch_stats": payload["a2j"]["batch_stats"]}
    return f_vars, fcfg, a_vars, acfg, payload.get("synth", {})
