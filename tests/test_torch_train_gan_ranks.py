"""`cli.train_gan` over two gloo ranks on the CPU (subprocesses of
tests/torch_train_gan_worker.py on a free port, `--mesh 2x1`), at the tiny
x8 face training config of tests/test_torch_cli_train_gan.py (global batch
2, one row a rank, SNAPSHOT_INTERVAL 1: an asynchronous checkpoint write in
flight after every step):

- a whole run of 4 steps;
- a `--fsdp` run that rank 1 alone is told to stop (SIGTERM after its second
  step), while the write of step 2 runs in rank 0's and rank 1's background
  threads: both ranks agree to stop after step 2, take no second
  checkpoint of it, and exit;
- `--resume` of it without `--fsdp` (the sharded checkpoint restored onto
  the replicated layout) ends on the whole run's step-4 snapshot pair, byte
  for byte.

A rank that does not exit within the time limit fails the test: the stop
flag's reduction and the writer's collectives share no group.
"""

import json
import os
import subprocess
import sys

from tgsr_tpu_torch.parallel.multihost import free_port
from tests.test_torch_cli_train_gan import YAML
from tests.torch_cli_data import make_train_face_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SECONDS = 120


def snapshot_bytes(out, it):
    return tuple(open(os.path.join(out, "Model", f"{net}_it{it}.msgpack"), "rb").read()
                 for net in ("netG", "netGH"))


def test_two_ranks_stop_together_and_resume(tmp_path):
    data = str(tmp_path / "data")
    make_train_face_set(data, n=5, seed=3)  # 4 train images: 2 steps an epoch
    cfg = tmp_path / "train.yml"
    cfg.write_text(YAML)
    base = ["--cfg", str(cfg), "--data_dir", data, "--device", "cpu", "--log_every", "1",
            "--mesh", "2x1", "--epochs", "2"]
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    spec = {"out": str(tmp_path / "summary"), "runs": [
        {"argv": base + ["--out_dir", whole], "sigterm_after": None},
        {"argv": base + ["--out_dir", part, "--fsdp"], "sigterm_after": 2},
        {"argv": base + ["--out_dir", part, "--resume"], "sigterm_after": None}]}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = str(free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    ranks = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                            "torch_train_gan_worker.py"),
                               str(spec_path), str(r), "2", port], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in ranks:
            logs.append(p.communicate(timeout=RANK_SECONDS)[0].decode())
    except subprocess.TimeoutExpired:
        for p in ranks:
            p.kill()
        raise AssertionError(f"a rank did not exit within {RANK_SECONDS} s")
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    want = [{"start_step": 0, "steps": 4, "stopped": False, "fsdp": False, "latest_step": 4},
            {"start_step": 0, "steps": 2, "stopped": True, "fsdp": True, "latest_step": 2},
            {"start_step": 2, "steps": 4, "stopped": False, "fsdp": False, "latest_step": 4}]
    for r in range(2):
        with open(f"{spec['out']}.{r}.json") as f:
            assert json.load(f) == want, r
    assert "interrupted; saving final checkpoint" in logs[0]
    assert sorted(os.listdir(os.path.join(part, "ckpt"))) == ["2", "3", "4"]
    assert snapshot_bytes(part, 4) == snapshot_bytes(whole, 4)
