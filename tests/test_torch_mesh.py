"""The port's mesh helpers (tgsr_tpu_torch/parallel/) against tgsr_tpu's, on
the CPU, in one process:

- `parse_mesh_arg`, `fsdp_spec`, `pad_to_multiple` and `process_local_slice`
  give JAX's answers on the same inputs (JAX's PartitionSpec is a tuple;
  the process count and index patched on both sides);
- `land_batch` takes a rank's rows and its metadata;
- a 1x1 mesh in a single process (a process group of one) steps the GAN
  trainer bit for bit as no mesh does, with and without `fsdp`, and the
  training CLI with `--mesh 1x1 --fsdp` writes the plain run's snapshot
  bytes;
- within `data_parallel.couple_one_rank` the group of one rank is kept: the
  DP step (with SimpleCNN's DAMSM terms) runs BN's global moments and the
  cross-rank gathers, the fsdp step shards its parameters over the one rank
  and equals DP bit for bit, and both stay within the float32 gates of
  tests/test_torch_data_parallel.py of the plain step (metrics rtol 1e-4,
  Adam's moments relative L2 1e-3 a tensor, BN stats relative L2 1e-4, at
  most 1 % of parameter and EMA entries more than 1e-6 apart);
- the CLIs' messages: `--fsdp` without `--mesh`, a batch the data axis does
  not divide, a mesh over more ranks than the process has (naming
  torchrun), a DAMSM model axis;
- `--tensorboard`: event files where the package imports, and JAX's
  "tensorboard writer unavailable (...); JSONL only" where it does not.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tgsr_tpu.parallel import mesh as jmesh
from tgsr_tpu.parallel import multihost as jmultihost
from tgsr_tpu_torch.checkpoints.from_jax import (seeded_cnn_encoder_state_dict,
                                                 seeded_text_state_dict)
from tgsr_tpu_torch.cli import pretrain_damsm, train_gan
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer
from tgsr_tpu_torch.models.image_encoder import make_image_encoder
from tgsr_tpu_torch.parallel import data_parallel, mesh, multihost
from tgsr_tpu_torch.utils.observability import MetricsLogger
from tests.test_torch_cli_pretrain_damsm import YAML as DAMSM_YAML
from tests.test_torch_cli_train_gan import YAML as GAN_YAML
from tests.torch_cli_data import make_train_face_set
from tests.torch_train_parity import VOCAB, batch, train_configs

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", ["8x1", "2X4", "1x1", "8", "2x2x2", "0x1", "ax1", "4x-1"])
def test_parse_mesh_arg_matches_jax(spec):
    try:
        want = jmesh.parse_mesh_arg(spec)
    except ValueError:
        with pytest.raises(ValueError):
            mesh.parse_mesh_arg(spec)
        return
    assert mesh.parse_mesh_arg(spec) == want


def test_fsdp_spec_matches_jax():
    shapes = [(), (7,), (1023,), (1024,), (32, 32), (3, 3, 64, 128), (5, 7, 9), (2048, 3),
              (6, 1024), (1, 1, 3, 2048), (300, 12), (256,)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            for min_el in (1024, 1):
                want = tuple(jmesh.fsdp_spec(shape, n, "data", min_el))
                assert mesh.fsdp_spec(shape, n, "data", min_el) == want, (shape, n, min_el)


def test_pad_to_multiple_matches_jax():
    rng = np.random.default_rng(0)
    for n, m, axis in ((5, 4, 0), (8, 4, 0), (3, 8, 1), (1, 2, 0)):
        x = rng.standard_normal((n, n + 1, 2))
        want, wn = jmesh.pad_to_multiple(x, m, axis)
        got, gn = mesh.pad_to_multiple(x, m, axis)
        assert gn == wn
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_process_local_slice_and_land_batch_match_jax(monkeypatch, count):
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(multihost, "process_count", lambda: count)
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(multihost, "process_index", lambda: index)
        for n in (4, 8, 16):
            assert multihost.process_local_slice(n) == jmultihost.process_local_slice(n)
        b = {"hr": np.arange(8 * 3).reshape(8, 3), "keys": [f"k{i}" for i in range(8)],
             "pyr": [np.arange(8), np.ones((8, 2))], "n": np.int32(8)}
        rows = multihost.land_batch(b)
        sl = jmultihost.process_local_slice(8)
        np.testing.assert_array_equal(rows["hr"], b["hr"][sl])
        np.testing.assert_array_equal(rows["pyr"][1], b["pyr"][1][sl])
        assert rows["keys"] == b["keys"][sl] and rows["n"] == 8
    assert multihost.is_main_process() == (count == 1)


@pytest.fixture
def group_of_one():
    """A process group of this process alone, torn down after."""
    assert not dist.is_initialized()
    m = mesh.make_mesh(1, 1, device="cpu")
    yield m
    dist.destroy_process_group()


def test_mesh_of_one_steps_as_no_mesh(group_of_one):
    m = group_of_one
    assert mesh.batch_shards(m) == 1 and mesh.data_index(m) == 0
    assert mesh.batch_axes(m) == ("data",)
    _, cfg = train_configs()
    text = seeded_text_state_dict(cfg, VOCAB, torch.Generator().manual_seed(3))
    b = batch(4, (6, 3, 0, 5), seed=1)
    out = []
    for kw in ({}, {"mesh": m}, {"mesh": m, "fsdp": True}):
        t = GANTrainer(cfg, VOCAB, text, device="cpu", **kw)
        s = t.init_state(torch.Generator().manual_seed(0))
        metrics = t.train_step(s, b)
        out.append((metrics, multihost.fetch_to_host(s.state_dict())))
    for metrics, sd in out[1:]:
        assert all(torch.equal(metrics[k], out[0][0][k]) for k in metrics)
        assert [k for k in sd if not torch.equal(sd[k], out[0][1][k])] == []
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        GANTrainer(cfg, VOCAB, text, device="cpu", fsdp=True)


def _rel(a, b):
    a, b = a.double(), b.double()
    n = a.norm()
    return float((a - b).norm() / n) if n > 0 else float((a - b).norm())


def test_couple_one_rank_drives_the_coupled_code(group_of_one, monkeypatch):
    m = group_of_one
    _, cfg = train_configs()
    text = seeded_text_state_dict(cfg, VOCAB, torch.Generator().manual_seed(3))
    enc = make_image_encoder(True, 32)
    enc.load_state_dict(seeded_cnn_encoder_state_dict(True, 32, torch.Generator().manual_seed(5)))
    b = {**batch(4, (6, 3, 1, 5), seed=1), "class_ids": np.array([1, 2, 1, 3], np.int32)}
    calls = {"all_reduce_sum": 0, "gather_rows": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(data_parallel, name, counted(name, getattr(data_parallel, name)))

    def run(**kw):
        t = GANTrainer(cfg, VOCAB, text, device="cpu", image_encoder=enc,
                       loss_weights={"damsm": 0.5}, **kw)
        s = t.init_state(torch.Generator().manual_seed(0))
        metrics = {k: float(v) for k, v in t.train_step(s, b).items()}
        return metrics, multihost.fetch_to_host(s.state_dict()), len(s.shards)

    plain = run()
    assert calls == {"all_reduce_sum": 0, "gather_rows": 0}
    with data_parallel.couple_one_rank():
        dp = run(mesh=m)
        assert calls["all_reduce_sum"] > 0 and calls["gather_rows"] > 0, calls
        fs = run(mesh=m, fsdp=True)
    assert run(mesh=m, fsdp=True)[2] == 0  # outside: one rank shards nothing
    assert dp[2] == 0 and fs[2] > 0
    assert fs[0] == dp[0] and [k for k in dp[1] if not torch.equal(dp[1][k], fs[1][k])] == []
    ref, got = plain[1], dp[1]
    for k, v in plain[0].items():
        assert abs(dp[0][k] - v) <= 1e-4 * abs(v), k
    params = 0
    for k in ref:
        if k.endswith(("exp_avg", "exp_avg_sq")):
            assert _rel(ref[k], got[k]) <= 1e-3, k
        elif "running_" in k:
            assert _rel(ref[k], got[k]) <= 1e-4, k
        elif ref[k].is_floating_point() and not k.startswith(("g_opt.", "d_opt.")):
            params += int(((ref[k] - got[k]).abs() > 1e-6).sum())
        else:
            assert torch.equal(ref[k], got[k]), k
    assert params <= 0.01 * sum(ref[k].numel() for k in ref if ref[k].is_floating_point()
                                and "running_" not in k and not k.startswith(("g_opt.",
                                                                              "d_opt.")))


def test_hybrid_mesh_of_one(group_of_one):
    h = mesh.make_hybrid_mesh(1, 1, 1, device="cpu")
    assert mesh.batch_axes(h) == ("dcn", "data") and mesh.batch_shards(h) == 1
    assert dist.get_world_size(mesh.batch_group(h)) == 1
    with pytest.raises(ValueError, match="hybrid mesh 2x1x1 needs 2 devices, have 1"):
        mesh.make_hybrid_mesh(2, 1, 1, device="cpu")


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    data = str(root / "data")
    make_train_face_set(data, n=5, seed=3)
    (root / "train.yml").write_text(GAN_YAML)
    (root / "damsm.yml").write_text(DAMSM_YAML)
    gan = ["--cfg", str(root / "train.yml"), "--data_dir", data, "--device", "cpu"]
    damsm = ["--cfg", str(root / "damsm.yml"), "--data_dir", data, "--simple-cnn",
             "--device", "cpu"]
    return dict(root=root, gan=gan, damsm=damsm)


@pytest.mark.parametrize("cli,argv,message", [
    ("gan", ["--fsdp"], "--fsdp requires --mesh"),
    ("gan", ["--mesh", "4x1"], "TRAIN.BATCH_SIZE=2 not divisible by the data axis (4)"),
    ("gan", ["--mesh", "2x1"], "torchrun --nproc_per_node 2"),
    ("gan", ["--mesh", "1x8", "--fsdp"], "mesh 1x8 needs more than 1 devices"),
    ("damsm", ["--mesh", "2x1"], "torchrun --nproc_per_node 2"),
    ("damsm", ["--mesh", "1x2"], "DAMSM training has no model-parallel axis; use --mesh DATAx1"),
    ("damsm", ["--mesh", "4x1"], "cfg.TRAIN.BATCH_SIZE=2 is not divisible by the mesh data "
                                 "axis (4)"),
    ("damsm", ["--mesh", "x1"], "--mesh expects DATAx1 (e.g. 8x1), got 'x1'"),
])
def test_cli_messages(cli_env, capsys, cli, argv, message):
    main = train_gan.main if cli == "gan" else pretrain_damsm.main
    out = str(cli_env["root"] / "never")
    with pytest.raises(SystemExit):
        main(cli_env[cli] + ["--out_dir", out] + argv)
    assert message in capsys.readouterr().err
    assert not os.path.exists(out)
    assert not dist.is_initialized()


def test_cli_mesh_of_one_with_fsdp_writes_the_plain_runs_bytes(cli_env):
    plain = str(cli_env["root"] / "plain")
    train_gan.main(cli_env["gan"] + ["--out_dir", plain, "--epochs", "1"])
    sharded = str(cli_env["root"] / "sharded")
    try:
        s = train_gan.main(cli_env["gan"] + ["--out_dir", sharded, "--epochs", "1",
                                             "--mesh", "1x1", "--fsdp"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert s["trainer"].fsdp and s["steps"] == 2
    for name in ("netG_it2.msgpack", "netGH_it2.msgpack"):
        with open(os.path.join(plain, "Model", name), "rb") as f, \
                open(os.path.join(sharded, "Model", name), "rb") as g:
            assert f.read() == g.read(), name


def test_tensorboard_mirror(tmp_path, monkeypatch, capsys):
    """Where torch.utils.tensorboard imports, the scalars go to Log/tb event
    files beside the JSONL; where it does not (the card machine has no
    tensorboard package), JAX's note and JSONL only."""
    try:
        import torch.utils.tensorboard  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        log = MetricsLogger(str(tmp_path / "tb_on"), tensorboard=True)
        log.log(3, loss=1.5)
        log.close()
        events = os.listdir(tmp_path / "tb_on" / "tb")
        assert events and events[0].startswith("events.out.tfevents")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path / "tb_off"), tensorboard=True)
    assert "tensorboard writer unavailable (" in capsys.readouterr().out
    log.log(4, loss=2.5)
    log.close()
    assert not os.path.exists(tmp_path / "tb_off" / "tb")
    with open(tmp_path / "tb_off" / "metrics.jsonl") as f:
        assert json.loads(f.readline())["loss"] == 2.5
