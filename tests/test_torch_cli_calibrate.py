"""The port's calibration CLI (tgsr_tpu_torch/cli/calibrate.py, `--device
cpu`) against tgsr_tpu's cli.calibrate on one example set and one set of
seeded .pth weights (tests/torch_cli_data.py).

Gates: the augmented views bit for bit JAX's (the codec's PIL-exact crop,
flip and BICUBIC resize, the same rng draws); `--batches 2` scales within
1e-4 relative of JAX's (the same float32 absmaxes, summed in another
order), the same keys and '_meta' (weights fingerprint included); each
JSON accepted by both packages' `check_scales` on the same weights, and
refused on other weights; `cli.test --scales` serves the port's file in
bfloat16 and float32 compute; `--gate_db 99` writes nothing; `--no-heads`
drops exactly the image heads. JAX reads the images through PIL, as the
port does (where its native loader is built it reads them within a level
of PIL)."""

import json
import os

import numpy as np
import pytest
import torch

from tgsr_tpu import native
from tgsr_tpu.cli import calibrate as jcal
from tgsr_tpu.cli.calibrate import augmented_lr_batch as jaugmented
from tgsr_tpu.config import config_from_file as jconfig_from_file
from tgsr_tpu.checkpoints.convert_torch import load_generator_pair as jload_pair
from tgsr_tpu.engine import quant as jq
from tgsr_tpu_torch.checkpoints.from_jax import conv_sites
from tgsr_tpu_torch.checkpoints.reference import load_generator_pair
from tgsr_tpu_torch.cli import calibrate as tcal
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.engine import quant as tq
from tgsr_tpu_torch.engine.inference import _modules
from tests.torch_cli_data import common_args, fresh_data, make_env

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(str(tmp_path_factory.mktemp("cli_calibrate")), n_attr=(1, 1))


@pytest.fixture(scope="module")
def scales(env):
    """Both packages' `--batches 2 --batch 2` JSON, and the port's summary.
    JAX reads its images through PIL here, as the port does: where its
    native loader is built it would read them within a level of PIL."""
    out = {}
    for pkg, main in (("jax", jax_pil_main), ("torch", tcal.main)):
        path = os.path.join(env["root"], f"scales_{pkg}.json")
        argv = common_args(env) + ["--data_dir", fresh_data(env, f"cal_{pkg}"), "--out", path,
                                   "--batch", "2", "--batches", "2"]
        summary = main(argv + (["--device", "cpu"] if pkg == "torch" else []))
        with open(path) as f:
            out[pkg] = json.load(f)
        out[f"{pkg}_summary"] = summary
    return out


def jax_pil_main(argv):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return jcal.main(argv)


@pytest.mark.parametrize("shape", [(3, 70, 60), (2, 256, 256), (2, 20, 24)])
def test_augmented_views_match_jax(shape):
    """Crops of 0.6-1.0 of the short side, flips, BICUBIC to 32 px and
    noise; (2, 20, 24): below the LR size, the crop reaches past the image
    (PIL pads it with zeros)."""
    hr = np.random.default_rng(shape[1]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        got, want = tcal.augmented_lr_batch(hr, 32, r1), jaugmented(hr, 32, r2)
        assert got.dtype == want.dtype == np.float32 and got.shape == (shape[0], 32, 32, 3)
        np.testing.assert_array_equal(got, want)


def test_scales_match_jax(scales):
    j = {k: v for k, v in scales["jax"].items() if k != "_meta"}
    t = {k: v for k, v in scales["torch"].items() if k != "_meta"}
    assert t.keys() == j.keys() == {"netg", "netgh"}
    for g in j:
        assert t[g].keys() == j[g].keys() and j[g]
        for k in j[g]:
            assert abs(t[g][k] - j[g][k]) <= 1e-4 * j[g][k], (g, k, t[g][k], j[g][k])
    assert any("img_net" in k or "conv_output" in k for g in t.values() for k in g)
    jm, tm = scales["jax"]["_meta"], scales["torch"]["_meta"]
    assert tm.keys() == jm.keys()
    for k in ("weights_fingerprint", "checkpoint", "text_encoder", "calibration",
              "gate_protocol"):
        assert tm[k] == jm[k], k
    assert tm["gate_db"] >= 35 and abs(tm["gate_db"] - jm["gate_db"]) <= 3.0


def test_each_package_accepts_the_others_scales(scales, env):
    """check_scales of each package on the other's JSON (keys and
    fingerprint against the same .pth weights), and each JSON refused
    against other weights."""
    cfg = tcli.load_config(env["cfg"])
    netg_sd, netgh_sd, _ = load_generator_pair(cfg, os.path.join(env["ckpt"], "netG_epoch_7.pth"))
    _, netg, netgh = _modules(cfg, env["n_words"], torch.load(env["text_encoder"]), netg_sd,
                              netgh_sd)
    jnetg, jnetgh = jload_pair(jconfig_from_file(env["cfg"]),
                               os.path.join(env["ckpt"], "netG_epoch_7.pth"), None)
    weight = netg.get_submodule(conv_sites(netg, netgh)["netg"]["h_net1/im2f_conv"]).weight
    kept = weight.detach().clone()
    for pkg in ("jax", "torch"):
        groups, meta = tq.split_scales_meta(scales[pkg])
        tq.check_scales(groups, netg, netgh, meta=meta)
        jq.check_scales(groups, jnetg, jnetgh, meta=meta)
        with torch.no_grad():
            weight.add_(1.0)
        with pytest.raises(ValueError, match="fingerprint"):
            tq.check_scales(groups, netg, netgh, meta=meta)
        with torch.no_grad():
            weight.copy_(kept)


def test_eval_cli_serves_the_port_scales(scales, env):
    """cli.test --scales on the port's JSON: int8 serving without the
    batch-0 calibration, in bfloat16 and in float32 compute."""
    for extra in ([], ["--no-bf16"]):
        s = tcli.main(common_args(env) + extra + [
            "--data_dir", fresh_data(env, f"scales{len(extra)}"), "--scales",
            os.path.join(env["root"], "scales_torch.json"), "--device", "cpu",
            "--out_dir", os.path.join(env["root"], f"out_scales{len(extra)}"), "--batch", "2"])
        assert s["int8"] and s["images"] == s["grids"] == 3


def test_gate_refuses_to_write(env):
    path = os.path.join(env["root"], "never.json")
    with pytest.raises(SystemExit, match="fidelity gate failed"):
        tcal.main(common_args(env) + ["--data_dir", fresh_data(env, "gate"), "--out", path,
                                      "--batch", "2", "--batches", "1", "--gate_db", "99",
                                      "--device", "cpu"])
    assert not os.path.exists(path)


def test_no_heads_drops_the_heads(scales, env):
    path = os.path.join(env["root"], "noheads.json")
    tcal.main(common_args(env) + ["--data_dir", fresh_data(env, "noheads"), "--out", path,
                                  "--batch", "2", "--batches", "1", "--no-heads",
                                  "--device", "cpu"])
    with open(path) as f:
        got = json.load(f)
    full = {k: v for k, v in scales["torch"].items() if k != "_meta"}
    assert {g: set(v) for g, v in tq.drop_head_scales(full).items()} == \
        {g: set(v) for g, v in got.items() if g != "_meta"}
    assert got["_meta"]["calibration"] == "1 views, margin 1.1"
