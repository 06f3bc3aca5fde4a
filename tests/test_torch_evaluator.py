"""tgsr_tpu_torch's `evaluate_sr` against tgsr_tpu's on the CPU: the same
float32 seeded weights (one tgsr_tpu init carried across with
`state_dicts_from_jax`) and the same numpy-seeded HR batches.

Gates: PSNR-Y within 0.02 dB and SSIM-Y within 2e-4 of JAX's (the two
pipelines' SR differs by float32 reassociation, which moves a Y value by
one level where it lands on a rounding boundary); `images` equal; JAX's
`max_images` and empty-iterator cases.
"""

import numpy as np
import pytest
import torch

from tgsr_tpu.engine.evaluator import evaluate_sr as jevaluate_sr
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu_torch.checkpoints.from_jax import state_dicts_from_jax
from tgsr_tpu_torch.engine.evaluator import evaluate_sr
from tgsr_tpu_torch.engine.inference import SRPipeline
from tests.torch_parity import SMALL, VOCAB, configs, jax_trees

torch.set_num_threads(1)
HR = SMALL["BASE_SIZE"] * 8
T = SMALL["WORDS_NUM"]


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    return (JSRPipeline(jcfg, VOCAB, *trees),
            SRPipeline(tcfg, VOCAB, *state_dicts_from_jax(*trees), device="cpu"))


def _batches(n_batches, b, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        lens = rng.integers(1, T + 1, b).astype(np.int32)
        caps = np.zeros((b, T), np.int32)
        for j in range(b):
            caps[j, :lens[j]] = rng.integers(1, VOCAB, lens[j])
        # a smooth HR (a blurred ramp plus noise), so that PSNR and SSIM
        # are not at the floor of a random image
        yy, xx = np.mgrid[:HR, :HR]
        base = (yy[None, ..., None] + xx[None, ..., None] * rng.uniform(0.5, 2, (b, 1, 1, 3)))
        hr = np.clip(base * 255.0 / base.max() + rng.normal(0, 8, (b, HR, HR, 3)), 0, 255)
        yield {"hr": hr.astype(np.uint8), "captions": caps, "cap_lens": lens}


def test_evaluate_sr_matches_jax(pipes):
    jpipe, tpipe = pipes
    want = jevaluate_sr(jpipe, _batches(3, 2))
    got = evaluate_sr(tpipe, _batches(3, 2))
    assert got["images"] == want["images"] == 6
    assert abs(got["psnr_y"] - want["psnr_y"]) <= 0.02, (got, want)
    assert abs(got["ssim_y"] - want["ssim_y"]) <= 2e-4, (got, want)
    assert got["images_per_sec_host_e2e"] > 0
    assert set(got) == set(want)
    again = evaluate_sr(tpipe, _batches(3, 2))
    assert (again["psnr_y"], again["ssim_y"]) == (got["psnr_y"], got["ssim_y"])


def test_evaluate_sr_max_images_and_empty(pipes):
    jpipe, tpipe = pipes
    got = evaluate_sr(tpipe, _batches(5, 2), max_images=4)
    want = jevaluate_sr(jpipe, _batches(5, 2), max_images=4)
    assert got["images"] == want["images"] == 4
    empty = evaluate_sr(tpipe, iter(()))
    assert empty["images"] == 0 and np.isnan(empty["psnr_y"]) and np.isnan(empty["ssim_y"])
