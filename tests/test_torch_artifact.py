"""Deployment bundles: tgsr_tpu_torch's `save_artifact` / `load_artifact`
against tgsr_tpu's on the CPU.

- A JAX float32 bundle and a JAX int8 bundle (bfloat16 compute, scales from
  JAX's calibrate_quant) load in the port and give JAX's outputs within the
  pipeline gates: float32 SR rtol = 1e-3, atol = 2e-4 (float
  reassociation); int8 uint8 PSNR >= 40 dB against JAX int8 (the gate of
  tests/test_torch_pipeline_int8.py: the two round a GLU gate differently).
- The port's own bundle round-trips bit for bit (float32, bfloat16, int8),
  with its vocab, under JAX's `use_quant` and `return_attn` contract; scales
  stamped for other weights, and a config.json the port does not serve,
  raise. A weight-map bundle, the port's and JAX's, loads.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tgsr_tpu.data.tokenizer import Vocab as JVocab
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.models.generator_hf import NetGHighWeight as JNetGHighWeight
from tgsr_tpu_torch.checkpoints.from_jax import init_seeded, state_dicts_from_jax
from tgsr_tpu_torch.data.tokenizer import Vocab
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.models.quantized import QuantConv
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees

torch.set_num_threads(1)
PYR = dict(rtol=1e-3, atol=2e-4)
T = SMALL["WORDS_NUM"]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    trees = jax_trees(jcfg)
    lr, cap, lens = inputs(2, SMALL["BASE_SIZE"], T, [T, 3], seed=31)
    jbf16 = JSRPipeline(jcfg, VOCAB, *trees, compute_dtype=jnp.bfloat16)
    scales = jbf16.calibrate_quant(lr, cap, lens)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees),
                scales=scales, inputs=(lr, cap, lens))


def _psnr_u8(a, b):
    d = to_uint8(torch.as_tensor(np.array(a))).double() - to_uint8(
        torch.as_tensor(np.array(b))).double()
    return 10 * np.log10(255 ** 2 / max(d.square().mean().item(), 1e-12))


def test_jax_f32_bundle_loads(setup, tmp_path):
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"])
    vocab = JVocab({0: "<end>", 1: "smile"}, {"<end>": 0, "smile": 1})
    jpipe.save_artifact(str(tmp_path), vocab=vocab)
    ref, _ = JSRPipeline.load_artifact(str(tmp_path))
    got, tvocab = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert got.compute_dtype == torch.float32 and not got.quant_scales
    assert tvocab == Vocab(vocab.ixtoword, vocab.wordtoix)
    assert got.a == pytest.approx(0.3)
    lr, cap, lens = setup["inputs"]
    np.testing.assert_allclose(got(lr, cap, lens)["sr"].numpy(),
                               np.asarray(ref(lr, cap, lens)["sr"]), **PYR)


def test_jax_int8_bundle_loads(setup, tmp_path):
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.bfloat16,
                        quant_scales=setup["scales"])
    jpipe.save_artifact(str(tmp_path))
    ref, _ = JSRPipeline.load_artifact(str(tmp_path))
    got, vocab = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert vocab is None
    assert got.compute_dtype == torch.bfloat16 and set(got.quant_scales) == {"netg", "netgh"}
    assert got.quant_meta["weights_fingerprint"] == json.load(
        open(tmp_path / "quant_scales.json"))["_meta"]["weights_fingerprint"]
    lr, cap, lens = setup["inputs"]
    assert _psnr_u8(got(lr, cap, lens)["sr"], ref(lr, cap, lens)["sr"]) >= 40


@pytest.mark.parametrize("path", ["float32", "bfloat16", "int8"])
def test_bundle_round_trips_bit_for_bit(setup, tmp_path, path):
    kw = {} if path == "float32" else dict(compute_dtype=torch.bfloat16)
    if path == "int8":
        kw["quant_scales"] = setup["scales"]
    pipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", **kw)
    vocab = Vocab({0: "<end>", 3: "hair"}, {"<end>": 0, "hair": 3})
    pipe.save_artifact(str(tmp_path), vocab=vocab)
    files = set(os.listdir(tmp_path))
    assert files == {"config.json", "meta.json", "state_dicts.pt", "vocab.json"} | (
        {"quant_scales.json"} if path == "int8" else set())
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta == {"vocab_size": VOCAB, "compute_dtype": str(pipe.compute_dtype)[6:],
                    "return_attn": False}
    loaded, got_vocab = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert got_vocab == vocab and loaded.cfg == pipe.cfg and loaded.a == pipe.a
    assert loaded.quant_scales == pipe.quant_scales
    lr, cap, lens = setup["inputs"]
    a, b = pipe(lr, cap, lens), loaded(lr, cap, lens)
    for p, q in zip(a["pyramid"], b["pyramid"]):
        assert torch.equal(p, q)


def test_use_quant_and_return_attn_contract(setup, tmp_path):
    """use_quant None serves as bundled, False ignores the scales, True
    needs them; return_attn saved by save_artifact, overridden by a kw."""
    q_dir, f_dir = str(tmp_path / "int8"), str(tmp_path / "f32")
    SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", compute_dtype=torch.bfloat16,
               quant_scales=setup["scales"]).save_artifact(q_dir, return_attn=True)
    SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
               return_attn=True).save_artifact(f_dir)
    as_bundled, _ = SRPipeline.load_artifact(q_dir, device="cpu")
    assert as_bundled.quant_scales and as_bundled.return_attn
    assert any(isinstance(m, QuantConv) for m in as_bundled.serve_netg.modules())
    plain, _ = SRPipeline.load_artifact(q_dir, device="cpu", use_quant=False, return_attn=False)
    assert not plain.quant_scales and not plain.return_attn
    assert plain.compute_dtype == torch.bfloat16
    assert not any(isinstance(m, QuantConv) for m in plain.serve_netg.modules())
    assert SRPipeline.load_artifact(q_dir, device="cpu", use_quant=True)[0].quant_scales
    with pytest.raises(ValueError, match="quant_scales"):
        SRPipeline.load_artifact(f_dir, device="cpu", use_quant=True)
    f32, _ = SRPipeline.load_artifact(f_dir, device="cpu")
    assert f32.return_attn and "attn" in f32(*setup["inputs"])
    bf16, _ = SRPipeline.load_artifact(f_dir, device="cpu", compute_dtype=torch.bfloat16)
    assert bf16.compute_dtype == torch.bfloat16


def test_fingerprint_mismatch_raises(setup, tmp_path):
    SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", compute_dtype=torch.bfloat16,
               quant_scales=setup["scales"]).save_artifact(str(tmp_path))
    path = tmp_path / "quant_scales.json"
    scales = json.load(open(path))
    scales["_meta"]["weights_fingerprint"] = "0" * 16
    json.dump(scales, open(path, "w"))
    with pytest.raises(ValueError, match="fingerprint"):
        SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert SRPipeline.load_artifact(str(tmp_path), device="cpu", use_quant=False)[0]


def test_unsupported_config_raises(setup, tmp_path):
    """A config.json the port does not serve (an RNN_TYPE other than LSTM
    and GRU) raises;
    a weight-map bundle (EVAL.WEIGHTMAP, 'lr-lrblur', at BASE_SIZE 32, where
    the x8 maps fit) saves its maps a1..a3 in netgh and no `a`, and loads
    back bit for bit."""
    SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu").save_artifact(str(tmp_path))
    cfg = json.load(open(tmp_path / "config.json"))
    cfg["RNN_TYPE"] = "RNN_TANH"
    json.dump(cfg, open(tmp_path / "config.json", "w"))
    with pytest.raises(NotImplementedError, match="RNN_TYPE"):
        SRPipeline.load_artifact(str(tmp_path), device="cpu")
    wcfg = dataclasses.replace(setup["tcfg"], TREE=dataclasses.replace(setup["tcfg"].TREE,
                                                                         BASE_SIZE=32),
                               EVAL=dataclasses.replace(setup["tcfg"].EVAL, WEIGHTMAP=True,
                                                        INPUT_NETGH="lr-lrblur"))
    sds = init_seeded(wcfg, VOCAB, torch.Generator().manual_seed(3))
    assert sds[3] is None
    pipe = SRPipeline(wcfg, VOCAB, *sds, device="cpu")
    pipe.save_artifact(str(tmp_path / "wm"))
    w = torch.load(tmp_path / "wm" / "state_dicts.pt", weights_only=True)
    assert "a" not in w and {"a1", "a2", "a3"} <= set(w["netgh"])
    back, _ = SRPipeline.load_artifact(str(tmp_path / "wm"), device="cpu")
    assert back.cfg.EVAL == wcfg.EVAL and back.a is None
    lr, cap, lens = inputs(2, 32, T, [T, 3], seed=32)
    assert torch.equal(back(lr, cap, lens)["sr"], pipe(lr, cap, lens)["sr"])


def test_jax_weight_map_bundle_loads(tmp_path):
    """JAX's own weight-map bundle (variables.msgpack: netgh params a1..a3,
    no 'a'; 'lr-lrblur') serves in the port at JAX's float32 outputs."""
    jcfg, tcfg = configs(base_size=32)
    jcfg = dataclasses.replace(jcfg, EVAL=dataclasses.replace(jcfg.EVAL, WEIGHTMAP=True,
                                                              INPUT_NETGH="lr-lrblur"))
    text, netg, _ = jax_trees(jcfg)
    gh = JNetGHighWeight(ngf=jcfg.GAN.GF_DIM, weightmap=True, low="lr-lrblur")
    lr0 = jnp.zeros((1, 32, 32, 3))
    netgh = unfreeze(jax.tree.map(np.asarray, gh.init(
        jax.random.PRNGKey(5), lr0, [jnp.zeros((1, z, z, 3)) for z in (64, 128, 256)], lr0)))
    rng = np.random.default_rng(5)
    for k in ("a1", "a2", "a3"):
        netgh["params"][k] = (1 + rng.uniform(-0.5, 0.5, netgh["params"][k].shape)).astype(
            np.float32)
    jpipe = JSRPipeline(jcfg, VOCAB, text, netg, netgh)
    jpipe.save_artifact(str(tmp_path))
    got, _ = SRPipeline.load_artifact(str(tmp_path), device="cpu")
    assert got.cfg.EVAL.WEIGHTMAP and got.a is None
    lr, cap, lens = inputs(2, 32, T, [T, 3], seed=33)
    np.testing.assert_allclose(got(lr, cap, lens)["sr"].numpy(),
                               np.asarray(jpipe(lr, cap, lens)["sr"]), **PYR)
