"""A GRU text encoder (RNN_TYPE 'GRU') through every entry point of
tgsr_tpu_torch, against tgsr_tpu on the CPU.

One seeded tgsr_tpu init of the small geometry (BN statistics perturbed,
blend a = 0.3) with a JAX GRU text encoder in place of the LSTM, carried
across with `state_dicts_from_jax`; inputs are numpy from a seed. Gates, the
existing ones of each path:

- serving, f32: every pyramid scale and the SR at the float-reassociation
  gate of tests/test_torch_pipeline.py (rtol 1e-3, atol 2e-4); bf16: PSNR
  >= 50 dB against JAX bf16 (tests/test_torch_pipeline_bf16.py); int8 on
  JAX's scales: uint8 PSNR >= 40 dB against JAX int8
  (tests/test_torch_pipeline_int8.py);
- a bundle (`save_artifact` / `load_artifact`) and an exported program
  (`aot.export_serving` / `AOTPipeline`) bit for bit the live pipeline;
- one GAN step (tests/test_torch_gan_trainer.py's `check_step`) and one
  DAMSM step (tests/test_torch_damsm_trainer.py's `check_step`) against
  JAX's step on the same state and batch;
- `cli.train_gan` and `cli.pretrain_damsm` on a tiny GRU YAML: snapshots
  that JAX's `load_variables` reads into the trees JAX's modules take.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgsr_tpu.checkpoints.io import load_variables as jax_load_variables
from tgsr_tpu.engine.damsm_trainer import DAMSMTrainer as JDAMSMTrainer
from tgsr_tpu.engine.gan_trainer import GANTrainer as JGANTrainer
from tgsr_tpu.engine.inference import SRPipeline as JSRPipeline
from tgsr_tpu.models.text_encoder import TextEncoder as JTextEncoder
from tgsr_tpu_torch.checkpoints.from_jax import (cnn_encoder_state_dict, state_dicts_from_jax,
                                                 text_state_dict)
from tgsr_tpu_torch.cli import pretrain_damsm, train_gan
from tgsr_tpu_torch.engine import aot
from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tgsr_tpu_torch.engine.inference import SRPipeline, to_uint8
from tgsr_tpu_torch.models.image_encoder import SIMPLE_SIZE
from tgsr_tpu_torch.models.text_encoder import TextEncoder
from tests import test_torch_damsm_trainer as damsm_t
from tests import test_torch_gan_trainer as gan_t
from tests.torch_cli_data import make_train_face_set
from tests.torch_parity import SMALL, VOCAB, configs, inputs, jax_trees
from tests.torch_train_parity import batch, jax_batch, load_jax_state, port_trees, train_configs

torch.set_num_threads(1)
T = SMALL["WORDS_NUM"]
PYR = dict(rtol=1e-3, atol=2e-4)


def gru(*cfgs):
    return tuple(dataclasses.replace(c, RNN_TYPE="GRU") for c in cfgs)


def gru_text_tree(vocab, nhidden, words_num, seed=0):
    """A JAX GRU TextEncoder init (numpy), biases moved off their draw so that
    a folded b_hn would show."""
    v = JTextEncoder(vocab_size=vocab, nhidden=nhidden, rnn_type="GRU").init(
        jax.random.PRNGKey(seed), jnp.ones((1, words_num), jnp.int32), jnp.ones((1,), jnp.int32))
    params = {k: np.asarray(x) for k, x in v["params"].items()}
    rng = np.random.default_rng(seed)
    for k in [k for k in params if k.startswith("b_")]:
        params[k] = (params[k] + rng.normal(0, 0.3, params[k].shape)).astype(np.float32)
    return {"params": params}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = gru(*configs())
    _, netg, netgh = jax_trees(jcfg)
    trees = (gru_text_tree(VOCAB, jcfg.TEXT.EMBEDDING_DIM, T), netg, netgh)
    return dict(jcfg=jcfg, tcfg=tcfg, trees=trees, sds=state_dicts_from_jax(*trees))


def _psnr(a, b, peak=2.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(peak ** 2 / max(mse, 1e-30))


def _u8(x):
    return to_uint8(torch.as_tensor(np.array(x))).numpy()


def test_pipeline_f32_matches_jax(setup):
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], return_attn=True)
    tpipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu", return_attn=True)
    assert tpipe.text_encoder.rnn_type == "GRU"
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 1, 0], seed=3)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    for i, (p, pr) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        np.testing.assert_allclose(p.numpy(), np.asarray(pr), **PYR, err_msg=f"scale {i}")
    np.testing.assert_allclose(got["sr"].numpy(), np.asarray(ref["sr"]), **PYR)


def test_pipeline_bf16_matches_jax(setup):
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.bfloat16)
    tpipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=torch.bfloat16)
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0], seed=4)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    for i, (p, pr) in enumerate(zip(got["pyramid"], ref["pyramid"])):
        assert _psnr(p.numpy(), np.asarray(pr)) >= 50.0, f"scale {i}"
    assert _psnr(got["sr"].numpy(), np.asarray(ref["sr"])) >= 50.0


def test_pipeline_int8_matches_jax(setup):
    lr, cap, lens = inputs(4, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 5], seed=11)
    scales = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"],
                         compute_dtype=jnp.bfloat16).calibrate_quant(lr, cap, lens)
    jpipe = JSRPipeline(setup["jcfg"], VOCAB, *setup["trees"], compute_dtype=jnp.bfloat16,
                        quant_scales=scales)
    tpipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=torch.bfloat16, quant_scales=scales)
    lr, cap, lens = inputs(3, setup["jcfg"].TREE.BASE_SIZE, T, [T, 2, 0], seed=12)
    ref, got = jpipe(lr, cap, lens), tpipe(lr, cap, lens)
    for p, pr in zip(got["pyramid"], ref["pyramid"]):
        assert _psnr(_u8(p.numpy()), _u8(pr), peak=255.0) >= 40.0


def test_bundle_and_exported_program(setup, tmp_path):
    """A GRU int8 bundle reloads as a GRU pipeline; a GRU exported program
    (symbolic batch) is bit for bit the live pipeline at B = 1 and 3."""
    lr, cap, lens = inputs(4, setup["jcfg"].TREE.BASE_SIZE, T, [T, 3, 0, 5], seed=13)
    calib = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                       compute_dtype=torch.bfloat16)
    scales = calib.calibrate_quant(lr, cap, lens)
    pipe = SRPipeline(setup["tcfg"], VOCAB, *setup["sds"], device="cpu",
                      compute_dtype=torch.bfloat16, quant_scales=scales)
    back, _ = SRPipeline.load_artifact(pipe.save_artifact(str(tmp_path / "bundle")),
                                       device="cpu")
    assert back.cfg.RNN_TYPE == "GRU" and back.text_encoder.rnn_type == "GRU"
    np.testing.assert_array_equal(back.sr_uint8(lr, cap, lens), pipe.sr_uint8(lr, cap, lens))
    program = aot.AOTPipeline(aot.export_serving(pipe, str(tmp_path / "aot")), device="cpu")
    for b in (1, 3):
        lr, cap, lens = inputs(b, setup["jcfg"].TREE.BASE_SIZE, T, [T, 0, 2][:b], seed=20 + b)
        np.testing.assert_array_equal(program.sr_uint8(lr, cap, lens),
                                      pipe.sr_uint8(lr, cap, lens))


def test_gan_step_matches_jax():
    """One x8 GAN step with a frozen GRU text encoder, from one JAX init, at
    every gate of tests/test_torch_gan_trainer.py."""
    jcfg, tcfg = gru(*train_configs())
    tv = gru_text_tree(VOCAB, jcfg.TEXT.EMBEDDING_DIM, jcfg.TEXT.WORDS_NUM, seed=1)
    jt = JGANTrainer(jcfg, VOCAB, tv, reuse_g_forward=True)
    js = jax.jit(lambda k: jt.init_state(k, gan_t.B, init_on_cpu=False))(jax.random.PRNGKey(0))
    pt = GANTrainer(tcfg, VOCAB, text_state_dict(tv), device="cpu")
    assert pt.text_encoder.rnn_type == "GRU"
    ps = pt.init_state(torch.Generator().manual_seed(0))
    load_jax_state(pt, ps, jax.tree.map(np.asarray, js))
    b = batch(gan_t.B, gan_t.LENS, seed=0)
    js, jm, _ = jt.train_step(js, jax_batch(b), jax.random.PRNGKey(2))
    pm = pt.train_step(ps, b)
    gan_t.check_step({k: float(v) for k, v in jm.items()}, gan_t.jax_trees(js),
                     {k: float(v) for k, v in pm.items()}, port_trees(ps))


def test_damsm_step_matches_jax():
    """One DAMSM step (SimpleCNN, dropout 0) that trains a GRU text encoder,
    at every gate of tests/test_torch_damsm_trainer.py. The images come at
    SimpleCNN's own 137 px, where both packages' resize is the identity:
    the float32 32 -> 137 px resize leaves the CNN's first layers
    ill-conditioned (that file's docstring), which is no property of the
    text encoder and is held there."""
    jcfg, tcfg = gru(*damsm_t.damsm_configs())
    jt = JDAMSMTrainer(jcfg, damsm_t.VOCAB, use_inception=False)
    js = jax.jit(lambda k: jt.init_state(k, SIMPLE_SIZE, damsm_t.B, init_on_cpu=False))(
        jax.random.PRNGKey(0))
    assert js.text_params["w_hh_fwd"].shape[1] == 3 * damsm_t.EMB // 2
    jt.text_encoder = jt.text_encoder.clone(drop_prob=0.0)
    pt = DAMSMTrainer(tcfg, damsm_t.VOCAB, use_inception=False, device="cpu")
    ps = pt.init_state(torch.Generator().manual_seed(0))
    assert ps.text.rnn_type == "GRU"
    pt.load_state(ps, text_state_dict({"params": jax.tree.map(np.asarray, js.text_params)}),
                  cnn_encoder_state_dict(jax.tree.map(np.asarray, {
                      "params": js.cnn_params, "batch_stats": js.cnn_stats})))
    ps.text.drop_prob = 0.0
    b = damsm_t.host_batch(0)
    b["hr"] = np.random.default_rng(0).integers(0, 256, (damsm_t.B, SIMPLE_SIZE, SIMPLE_SIZE, 3)
                                                ).astype(np.uint8)
    g64 = {"jax": damsm_t.jax_float64_grads(jt, js, b)}
    js1, jm = jt.train_step(js, jt._device_batch(b, None), 2e-4, jax.random.PRNGKey(0))
    db = pt.device_batch(b)
    g64["port"] = damsm_t.float64_grads(pt, ps, db)
    g64["resize f32"] = damsm_t.float64_grads(pt, ps, db, resize_in_float32=True)
    pm = pt.train_step(ps, db, 2e-4)
    run = {"jax": [({k: float(v) for k, v in jm.items()}, damsm_t.jax_state_trees(js1))],
           "port": [({k: float(v) for k, v in pm.items()}, damsm_t.port_state_trees(pt, ps),
                     g64)]}
    (jmet, jtree), (pmet, ptree, _) = run["jax"][0], run["port"][0]
    damsm_t.check_step(jmet, jtree, pmet, ptree, *damsm_t.step_grads(run, 0), g64)


TRAIN_YAML = """CONFIG_NAME: 'tiny_face_train_gru'
DATASET_NAME: 'face'
RNN_TYPE: 'GRU'
TREE:
    BRANCH_NUM: 4
    BASE_SIZE: 8
GAN:
    GF_DIM: 16
    DF_DIM: 16
    CONDITION_DIM: 10
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 2
"""

DAMSM_YAML = """CONFIG_NAME: 'tiny_face_damsm_gru'
DATASET_NAME: 'face'
RNN_TYPE: 'GRU'
TREE:
    BRANCH_NUM: 1
    BASE_SIZE: 32
TEXT:
    EMBEDDING_DIM: 32
    WORDS_NUM: 6
    CAPTIONS_PER_IMAGE: 1
TRAIN:
    FLAG: True
    BATCH_SIZE: 2
    MAX_EPOCH: 1
    SNAPSHOT_INTERVAL: 1
    ENCODER_LR: 0.002
"""


@pytest.fixture(scope="module")
def face_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("gru_cli")
    data = str(root / "data")
    return root, data, make_train_face_set(data, n=5, seed=3)


def test_cli_train_gan_with_a_gru_text_encoder(face_set):
    """--text_encoder a GRU `.pth` under RNN_TYPE 'GRU': snapshots that JAX
    reads into the tree of its own x8 init; an LSTM file is refused by name."""
    root, data, n_words = face_set
    (root / "train.yml").write_text(TRAIN_YAML)
    te = str(root / "text_encoder_gru.pth")
    torch.save(text_state_dict(gru_text_tree(n_words, 32, 6, seed=1)), te)
    base = ["--cfg", str(root / "train.yml"), "--data_dir", data, "--device", "cpu"]
    summary = train_gan.main(base + ["--text_encoder", te, "--out_dir", str(root / "gan"),
                                     "--epochs", "1"])
    assert summary["steps"] == 2
    g = jax_load_variables(str(root / "gan" / "Model" / "netG_it2.msgpack"))
    jcfg, _ = configs(base_size=8, gf_dim=16, condition_dim=10, embedding_dim=32, words_num=6)
    _, jnetg, _ = jax_trees(jcfg, vocab=n_words)
    assert jax.tree.structure(g) == jax.tree.structure(jnetg)
    lstm = str(root / "text_encoder_lstm.pth")
    torch.save(text_state_dict(jax_trees(jcfg, vocab=n_words)[0]), lstm)
    with pytest.raises(ValueError, match="holds a LSTM text encoder"):
        train_gan.main(base + ["--text_encoder", lstm, "--out_dir", str(root / "no")])


def test_cli_pretrain_damsm_trains_a_gru(face_set, capsys):
    """A GRU DAMSM run writes text_encoder0 that JAX's GRU TextEncoder takes
    and computes with as the port's does (rtol = atol = 1e-4); it resumes in
    the port."""
    root, data, n_words = face_set
    (root / "damsm.yml").write_text(DAMSM_YAML)
    base = ["--cfg", str(root / "damsm.yml"), "--data_dir", data, "--simple-cnn",
            "--device", "cpu"]
    out = pretrain_damsm.main(base + ["--out_dir", str(root / "damsm")])["out_dir"]
    snap = os.path.join(out, "Model", "text_encoder0.msgpack")
    tv = jax_load_variables(snap)
    jt = JTextEncoder(vocab_size=n_words, nhidden=32, rnn_type="GRU")
    caps = np.array([[1, 2, 3, 0, 0, 0], [2, 1, 4, 3, 2, 1]], np.int32)
    lens = np.array([3, 6], np.int32)
    init = jt.init(jax.random.PRNGKey(0), jnp.asarray(caps), jnp.asarray(lens))
    assert jax.tree.structure(tv) == jax.tree.structure(jax.tree.map(np.asarray, init))
    pt = TextEncoder(n_words, 300, 32, rnn_type="GRU").eval()
    pt.load_state_dict(text_state_dict(tv), strict=True)
    with torch.no_grad():
        port = pt(torch.from_numpy(caps).long(), torch.from_numpy(lens).long())
    for a, b in zip(port, jt.apply(tv, jnp.asarray(caps), jnp.asarray(lens))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    capsys.readouterr()
    pretrain_damsm.main(base + ["--out_dir", str(root / "resumed"), "--resume_from", snap])
    assert f"resumed encoders from {snap}" in capsys.readouterr().out
