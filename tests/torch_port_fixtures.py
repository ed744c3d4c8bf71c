"""Shared inputs for the tests that hold ``handnet_tpu_torch`` (the PyTorch
port) against ``handnet_tpu`` (the JAX reference).

Weights and inputs come from numpy seeds and reach both sides as numpy
arrays. Both sides run in float32 on the CPU; TF32 is switched off for the
port's convolutions and matmuls (a no-op on the CPU, stated so that the same
tests mean the same thing on a card).
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def randomize_norms(tree, seed: int):
    """Copy of a flax ``{"params", "batch_stats"}`` tree (numpy leaves) with
    every norm layer's scale, bias and running statistics drawn at random, so
    that the conversion of each one is exercised. Conv kernels and biases
    (the detector's prior bias among them) are kept."""
    rng = np.random.default_rng(seed)
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def walk(node):
        # a norm layer's params hold a scale; a conv's hold a kernel
        is_norm = "kernel" not in node
        out = {}
        for key, value in sorted(node.items()):
            if isinstance(value, dict):
                out[key] = walk(value)
            elif key in draw and is_norm:
                out[key] = draw[key](np.shape(value)).astype(np.float32)
            else:
                out[key] = np.asarray(value)
        return out

    return walk(tree)


def leaves_equal(a, b) -> bool:
    """Same nested keys and bit-equal leaves (dtype included)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(leaves_equal(a[k], b[k]) for k in a))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def nhwc(t: torch.Tensor) -> np.ndarray:
    """Port NCHW tensor -> numpy NHWC, the JAX package's layout."""
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_close(got, want, rtol: float, atol: float, err_msg: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=err_msg)


def fast_compile(fn, *args, jitted=None):
    """``jax.jit(fn)`` (or the already jitted ``jitted``) compiled for
    ``args`` with XLA's backend optimization off: the same operations; for
    A2J's few calls a third of the time on the CPU (the pipeline runs slower
    so, and is jitted as usual)."""
    import jax

    return (jitted or jax.jit(fn)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})


def jax_tool_defaults(tool: str) -> dict:
    """The flags and defaults of the JAX package's ``tools/<tool>.py``
    parser, read from its source: importing a JAX tool runs
    ``runtime.setup()``."""
    source = Path(__file__).resolve().parent.parent / "tools" / f"{tool}.py"
    flags = {}
    for node in ast.walk(ast.parse(source.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            name = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                flags[name] = ast.literal_eval(kw["default"])
            elif kw.get("action") is not None:
                flags[name] = False
    return flags
