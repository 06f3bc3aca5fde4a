"""The port's eval CLI (tgsr_tpu_torch/cli/test.py, `--device cpu`) against
tgsr_tpu's cli.test on one example set and one set of seeded .pth weights
(tests/torch_cli_data.py: a face set of 3 PNGs of 150 x 140 in the
reference's layout, BASE_SIZE 16, GF_DIM 8, 128 px SR).

Gates, per mode, on every `<key>_SR.png` against JAX's (uint8):
`--no-bf16` within 1 level (float reassociation); the bf16 default >= 50 dB;
`--int8` and `--no-bf16 --int8` >= 40 dB (each package calibrates on its own
float32 twin; the int8 gates of tests/test_torch_pipeline_int8.py). Every
image's attention grid is written with JAX's shape (the grid itself is held
bit for bit to JAX's on the same inputs in tests/test_torch_visualize.py).
Bundles from `--int8 --save_artifact` load in the port (its own, and JAX's)
and in JAX (its own). `--no-bf16 --metrics` within 0.02 dB PSNR-Y and 1e-3
SSIM-Y of the JSON JAX prints (rounded there to 4 decimals; the float32 SR
differs by a level where reassociation crosses a rounding boundary, which
moves the SSIM of three 128 px images by a few 1e-4); `--no-bf16
--arbitrary --bucket 16` within 1 level.

Each caption has one word, so each image's grid is one pyramid_expand to
256 px (about a second); every mode runs once per package.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tgsr_tpu import native
from tgsr_tpu.cli import test as jcli
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.cli import test as tcli
from tgsr_tpu_torch.data.codec import load_image_rgb
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_cli_data import common_args, fresh_data, make_env

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flags of each mode; --save_artifact takes the package's bundle directory
MODES = {"f32": ["--no-bf16", "--metrics"], "bf16": [], "int8": ["--int8", "--save_artifact"],
         "f32_int8": ["--no-bf16", "--int8"],
         "arbitrary": ["--no-bf16", "--arbitrary", "--bucket", "16"]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(str(tmp_path_factory.mktemp("cli_test")), n_attr=(1, 1))


def _bundle(env, pkg):
    return os.path.join(env["root"], f"bundle_{pkg}")


@pytest.fixture(scope="module")
def runs(env):
    """Each package's CLI in a mode, run once at first use: (the port's
    summary, or the last line JAX printed; the output directory)."""
    done = {}

    def run(pkg, mode):
        if (pkg, mode) not in done:
            tag = f"{pkg}_{mode}"
            argv = (common_args(env) + MODES[mode]
                    + ([_bundle(env, pkg)] if "--save_artifact" in MODES[mode] else [])
                    + ["--data_dir", fresh_data(env, tag), "--batch", "2",
                       "--out_dir", os.path.join(env["root"], f"out_{tag}")])
            if pkg == "jax":
                # JAX reads its images through PIL, as the port does (its
                # native loader, where built, reads them within a level)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as m:
                    m.setattr(native, "available", lambda: False)
                    jcli.main(argv)
                last = buf.getvalue().strip().splitlines()[-1]
                done[(pkg, mode)] = (last, os.path.join(env["root"], f"out_{tag}", "testset"))
            else:
                summary = tcli.main(argv + ["--device", "cpu"])
                done[(pkg, mode)] = (summary, summary["out_dir"])
        return done[(pkg, mode)]

    return run


def _images(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith("_SR.png"))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255 ** 2 / max(mse, 1e-12))


def _compare(runs, mode, shape=(128, 128, 3)):
    (summary, t_out), (_, j_out) = runs("torch", mode), runs("jax", mode)
    names = _images(j_out)
    assert names and _images(t_out) == names
    pairs = []
    for name in names:
        want = np.asarray(Image.open(os.path.join(j_out, name)).convert("RGB"))
        got = load_image_rgb(os.path.join(t_out, name))
        assert got.shape == want.shape == shape
        pairs.append((got, want))
    return summary, t_out, j_out, pairs


def _check_grids(t_out, j_out, summary):
    att = sorted(os.listdir(os.path.join(j_out, "att")))
    assert att and sorted(os.listdir(os.path.join(t_out, "att"))) == att
    assert summary["grids"] == len(att) == summary["images"]
    for name in att:
        want = np.asarray(Image.open(os.path.join(j_out, "att", name)).convert("RGB"))
        assert load_image_rgb(os.path.join(t_out, "att", name)).shape == want.shape


def test_f32_sr_within_one_level(runs):
    summary, t_out, j_out, pairs = _compare(runs, "f32")
    for got, want in pairs:
        assert np.abs(got.astype(int) - want).max() <= 1
    _check_grids(t_out, j_out, summary)
    assert summary["images"] == 3 and summary["compute_dtype"] == "float32"


def test_bf16_sr_at_50_db(runs):
    summary, t_out, j_out, pairs = _compare(runs, "bf16")
    for got, want in pairs:
        assert _psnr(got, want) >= 50
    _check_grids(t_out, j_out, summary)


@pytest.mark.parametrize("mode", ["int8", "f32_int8"])
def test_int8_sr_at_40_db(runs, mode):
    summary, t_out, j_out, pairs = _compare(runs, mode)
    assert summary["int8"]
    for got, want in pairs:
        assert _psnr(got, want) >= 40
    _check_grids(t_out, j_out, summary)


def test_bundles_load_in_both_packages(runs, env):
    """`--int8 --save_artifact`: the port's bundle serves in the port with
    the vocab and the scales, without attention maps; JAX's bundle loads in
    JAX and in the port."""
    t_bundle, j_bundle = _bundle(env, "torch"), _bundle(env, "jax")
    runs("torch", "int8")
    runs("jax", "int8")
    for path in (t_bundle, j_bundle):
        pipe, vocab = SRPipeline.load_artifact(path, device="cpu")
        assert vocab is not None and vocab.n_words == env["n_words"]
        assert pipe.quant_scales and not pipe.return_attn
        assert pipe.compute_dtype == torch.bfloat16
        lr = np.zeros((1, 16, 16, 3), np.float32)
        assert pipe.sr_uint8(lr, np.ones((1, 6), np.int64), np.array([6])).shape == (1, 128, 128, 3)
    jpipe, jvocab = JSRPipeline.load_artifact(j_bundle)
    assert jvocab.n_words == env["n_words"] and jpipe.quant_scales


def test_metrics_match_jax(runs):
    """`--no-bf16 --metrics`: evaluate_sr's PSNR-Y and SSIM-Y against
    JAX's printed JSON."""
    summary, _ = runs("torch", "f32")
    want = json.loads(runs("jax", "f32")[0])
    got = summary["metrics"]
    assert got["images"] == want["images"] == 3
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.02
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 1e-3


def test_arbitrary_bucket_within_one_level(runs):
    """`--no-bf16 --arbitrary --bucket 16`: each image at its own size
    (150 x 140 cropped to 144 x 136, LR 18 x 17, run at 32 x 32), no grids."""
    summary, t_out, _, pairs = _compare(runs, "arbitrary", shape=(144, 136, 3))
    assert summary["images"] == 3 and summary["lr_shapes"] == 1
    assert not os.listdir(os.path.join(t_out, "att"))
    for got, want in pairs:
        assert np.abs(got.astype(int) - want).max() <= 1


def test_scales_with_int8_refused(env, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(common_args(env) + ["--scales", "x.json", "--int8"])
    assert e.value.code == 2
    assert "--scales already selects int8" in capsys.readouterr().err


def test_default_device_needs_a_card(env):
    """No fallback: without a card the default --device cuda raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcli.main(common_args(env) + ["--data_dir", fresh_data(env, "nocard"),
                                      "--out_dir", os.path.join(env["root"], "out_nocard")])


def test_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "tgsr_tpu_torch.cli.test", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout and "--no-bf16" in out.stdout
