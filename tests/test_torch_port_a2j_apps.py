"""The port's A2J apps (``apps/train_a2j.py``, ``apps/eval_hpe.py``,
``apps/a2j_infer.py``) against the JAX package's, on the CPU.

``train_a2j`` runs once on the port's synthetic tree (crop 48, batch 8,
one epoch, float32, one worker); the JAX apps read its files: JAX's
``a2j_infer`` applies its ``params.npz``/``batch_stats.npz`` through the
JAX package's ``A2JSystem``, and JAX's ``eval_hpe`` reads its result file
and the tree. On the CPU the decode is K1's plain version (the kernel runs
on a card, where chip_smoke.py's ``[a2j_apps]`` phase drives these apps).

Tolerance: ``UVD_TOL`` of the UVD's largest magnitude between the port's
and JAX's float32 A2J forwards on the same weights (1.1e-5 of 24 px was
measured at crop 48 with random weights); the HPE numbers are equal.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
# torch imports its compiler stack at the first optimizer it builds, and
# that import walks sys.modules through inspect. tests/test_mano.py leaves
# chumpy stub modules there whose __getattr__ answers every name, __file__
# included, which breaks the walk; so import it at collection, before any
# test of the process runs.
import torch._dynamo  # noqa: F401

from handnet_tpu.apps import a2j_infer as ja2j_infer
from handnet_tpu.apps import eval_hpe as jeval_hpe
from handnet_tpu_torch.apps import a2j_infer, eval_hpe, train_a2j
from handnet_tpu_torch.data import dexycb, image_io

UVD_TOL = 1e-5
# what the JAX CLI writes into --output (tests/test_apps_smoke.py:21-34
# checks three of them), the checkpoints' own format aside
JAX_CLI_FILES = {"params.npz", "batch_stats.npz", "train.txt", "val.txt", "metrics.json",
                 "metrics.html", "a2j_test_metrics/s0_test_0.txt",
                 "dexycb_metrics/hpe_epoch_metrics.pkl", "dexycb_metrics/hpe_curve_0.html",
                 "cache/refined_train_idx.pkl", "cache/refined_test_idx.pkl"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One CPU epoch of the port's CLI on its own synthetic tree."""
    root = str(tmp_path_factory.mktemp("tree"))
    out = str(tmp_path_factory.mktemp("a2j"))
    res = train_a2j.main(["--data-dir", root, "--synthetic", "2", "--device", "cpu",
                          "--crop", "48", "--batch", "8", "--epochs", "1", "--no-bf16",
                          "--workers", "1", "--eval-every", "1", "--output", out])
    return root, out, res


@pytest.fixture(scope="module")
def depth_dir(trained, tmp_path_factory):
    """A folder of 5 of the tree's depth PNGs (batch 2 pads the last)."""
    root, _, _ = trained
    d = tmp_path_factory.mktemp("pngs")
    pngs = sorted(Path(root).rglob("*.png"))
    for i, p in enumerate(pngs[:5]):
        image_io.write_png(d / f"d{i}.png", image_io.read_png(p))
    return str(d)


def test_train_a2j_writes_what_the_jax_cli_writes(trained):
    root, out, res = trained
    written = {os.path.relpath(os.path.join(d, f), out)
               for d, _, files in os.walk(out) for f in files}
    assert JAX_CLI_FILES <= written, JAX_CLI_FILES - written
    assert os.path.exists(os.path.join(out, "checkpoints", "0.pt"))
    with open(os.path.join(out, "a2j_test_metrics", "s0_test_0.txt")) as f:
        lines = f.read().split()
    assert len(lines) == 8 and all(len(line.split(",")) == 64 for line in lines)
    epoch, = res["epochs"]
    assert epoch["steps"] == 1 and np.isfinite(list(epoch["losses"].values())).all()
    sweep, = res["evals"]
    assert sweep["batches"] == 1 and sweep["samples"] == 8
    assert all(np.isfinite(list(v.values())).all() for v in sweep["results"].values())


def test_params_npz_in_jax_and_a2j_infer_against_jax(trained, depth_dir, tmp_path):
    """JAX's ``a2j_infer`` applies the CLI's ``params.npz`` and
    ``batch_stats.npz`` through its ``A2JSystem``; the port's ``a2j_infer``
    on the same folder and files, and the trained model itself, agree with
    it within ``UVD_TOL``."""
    _, out, res = trained
    args = ["--input", depth_dir, "--checkpoint", out, "--crop", "48", "--batch", "2"]
    ja2j_infer.main(args + ["--output", str(tmp_path / "jax")])
    got = a2j_infer.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    want = np.load(tmp_path / "jax" / "all_joints_uvd.npy")
    assert got["uvd"].shape == want.shape == (5, 21, 3) and got["batches"] == 3
    np.testing.assert_array_equal(np.load(got["path"]), got["uvd"])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["uvd"], want, rtol=0, atol=UVD_TOL * scale)
    model = res["state"].model.eval()
    frames = a2j_infer.read_frames(sorted(
        os.path.join(depth_dir, f) for f in os.listdir(depth_dir)), 48)
    np.testing.assert_allclose(a2j_infer.predict_frames(model, frames, 2), want, rtol=0,
                               atol=UVD_TOL * scale)


def test_a2j_infer_torch_checkpoint_against_jax(trained, depth_dir, tmp_path):
    """A Lightning-style ``{"state_dict": {"a2j.…"}}`` file (with the
    reference's ``num_batches_tracked`` and unused ``fc`` entries): both
    apps unwrap it and transpose the anchors."""
    _, _, res = trained
    sd = {f"a2j.{k}": v.detach().clone() for k, v in res["state"].model.state_dict().items()}
    sd["a2j.Backbone.model.bn1.num_batches_tracked"] = torch.tensor(7)
    sd["a2j.Backbone.model.fc.weight"] = torch.zeros(10, 2048)
    path = tmp_path / "a2j.ckpt"
    torch.save({"epoch": 3, "state_dict": sd}, path)
    args = ["--input", depth_dir, "--torch-checkpoint", str(path), "--crop", "48", "--batch", "2"]
    ja2j_infer.main(args + ["--output", str(tmp_path / "jax")])
    got = a2j_infer.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    want = np.load(tmp_path / "jax" / "all_joints_uvd.npy")
    np.testing.assert_allclose(got["uvd"], want, rtol=0, atol=UVD_TOL * np.abs(want).max())


def test_eval_hpe_against_jax(trained, tmp_path):
    root, _, res = trained
    res_file = res["evals"][0]["res_file"]
    args = ["--res-file", res_file, "--data-dir", root, "--split", "s0_train"]
    got = eval_hpe.main(args + ["--out-dir", str(tmp_path / "port")])
    want = jeval_hpe.main(args + ["--out-dir", str(tmp_path / "jax")])
    assert got == want == res["evals"][0]["results"]
    assert ((tmp_path / "port" / "hpe_epoch_metrics.pkl").read_bytes()
            == (tmp_path / "jax" / "hpe_epoch_metrics.pkl").read_bytes())
    gt = tmp_path / "gt.npz"
    ds = dexycb.DexYCBDataset("s0", "train", root)
    np.savez(gt, **{str(k): v for k, v in dexycb.hpe_ground_truth(ds).items()})
    assert eval_hpe.main(["--res-file", res_file, "--gt-npz", str(gt)]) == want


def test_rgbd_and_vis_are_refused(tmp_path):
    """``--vis`` is refused (ROADMAP 13d). ``--rgbd`` no longer is: it
    builds the 4-channel A2J and its colour sources (one epoch of it runs in
    tests/test_torch_port_fcos_apps.py), so it gets as far as the data."""
    args = train_a2j.parse_args(["--rgbd", "--device", "cpu", "--output", str(tmp_path)])
    assert args.rgbd and train_a2j.device_keys(args.rgbd)["image"] == "rgbd"
    with pytest.raises(NotImplementedError, match="13d"):
        a2j_infer.main(["--input", str(tmp_path), "--vis", "--device", "cpu"])


def test_apps_default_to_the_card(monkeypatch, tmp_path, depth_dir):
    """Without ``--device`` each app runs on the card: where there is none
    it raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_a2j.main(["--synthetic", "1", "--output", str(tmp_path / "t")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a2j_infer.main(["--input", depth_dir, "--output", str(tmp_path / "i")])
