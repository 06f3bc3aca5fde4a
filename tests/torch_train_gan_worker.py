"""One rank of tests/test_torch_train_gan_ranks.py: run as
`python tests/torch_train_gan_worker.py SPEC RANK WORLD PORT` from the
repository root (gloo on the CPU, one thread). SPEC (JSON) holds "runs", each
{"argv": the arguments of `cli.train_gan`, "sigterm_after": a step or null},
and "out", a path prefix: the rank sends itself SIGTERM after that step when
it is rank 1 (as a scheduler stops one node first), runs `cli.train_gan.main`
under torchrun's variables, and writes what each run returned to
OUT.RANK.json. Imports torch and the port only."""

import json
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tgsr_tpu_torch.checkpoints import dcp_io  # noqa: E402
from tgsr_tpu_torch.cli import train_gan  # noqa: E402
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer  # noqa: E402

torch.set_num_threads(1)


def main(spec_path, rank, world, port):
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank, MASTER_ADDR="localhost",
                      MASTER_PORT=port)
    with open(spec_path) as f:
        spec = json.load(f)
    real_step = GANTrainer.train_step
    summaries = []
    for run in spec["runs"]:
        stop_after = run["sigterm_after"] if rank == "1" else None

        def step(self, state, batch, stop_after=stop_after):
            metrics = real_step(self, state, batch)
            if state.step == stop_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        GANTrainer.train_step = step
        try:
            r = train_gan.main(run["argv"])
        finally:
            GANTrainer.train_step = real_step
        summaries.append({"start_step": r["start_step"], "steps": r["steps"],
                          "stopped": r["stopped"], "fsdp": r["trainer"].fsdp,
                          "latest_step": dcp_io.latest_step(r["ckpt_dir"])})
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(summaries, f)


if __name__ == "__main__":
    main(*sys.argv[1:5])
