"""One rank of tests/test_torch_data_parallel.py: run as
`python tests/torch_dp_worker.py SPEC RANK WORLD PORT` from the repository
root (gloo on the CPU, one thread). SPEC (a torch.save'd dict) holds the
configs, the initial weights, the global batches and the paths; rank 0
writes what every scenario gave, whole tensors, to SPEC's "out". Imports
torch and the port only."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tgsr_tpu_torch.checkpoints import dcp_io  # noqa: E402
from tgsr_tpu_torch.engine.damsm_trainer import DAMSMTrainer  # noqa: E402
from tgsr_tpu_torch.engine.gan_trainer import GANTrainer  # noqa: E402
from tgsr_tpu_torch.losses import gan as gan_losses  # noqa: E402
from tgsr_tpu_torch.models.image_encoder import make_image_encoder  # noqa: E402
from tgsr_tpu_torch.parallel import data_parallel  # noqa: E402
from tgsr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tgsr_tpu_torch.parallel.multihost import fetch_to_host, land_batch  # noqa: E402

torch.set_num_threads(1)


def gan_trainer(spec, mesh, fsdp=False, dtype=torch.float32):
    enc = make_image_encoder(True, spec["nef"])
    enc.load_state_dict(spec["cnn_sd"])
    return GANTrainer(spec["gan_cfg"], spec["vocab"], spec["text_sd"], image_encoder=enc,
                      loss_weights={"damsm": 0.5}, compute_dtype=dtype, device="cpu",
                      mesh=mesh, fsdp=fsdp)


def gan_state(t, spec):
    s = t.init_state(torch.Generator().manual_seed(0))
    s.load_state_dict(spec["gan_init"])
    return s


def gan_step(spec, mesh, fsdp=False, dtype=torch.float32):
    t = gan_trainer(spec, mesh, fsdp, dtype)
    s = gan_state(t, spec)
    m = t.train_step(s, land_batch(spec["gan_batch"], mesh))
    return t, s, {k: float(v) for k, v in m.items()}


def local_moments(x, group):
    """Ablation: BatchNorm's moments of this rank's rows alone."""
    return x


def local_pairs(fn):
    """Ablation: the mismatched pairs within this rank's rows alone (each
    rank sees its own captions where the next rank's should be)."""
    def run(*args, **kw):
        real = data_parallel.gather_rows
        data_parallel.gather_rows = lambda x, group: torch.cat(
            [x] * data_parallel.group_size(group))
        try:
            return fn(*args, **kw)
        finally:
            data_parallel.gather_rows = real
    return run


def main(spec_path, rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(world, 1, device="cpu")
    out = {}

    _, s, m = gan_step(spec, mesh)
    out["gan_dp"] = (m, fetch_to_host(s.state_dict()))
    _, s, m = gan_step(spec, mesh, dtype=torch.float64)
    out["gan_dp64"] = (m, fetch_to_host(s.state_dict()))
    t, s, m = gan_step(spec, mesh, fsdp=True)
    out["gan_fsdp"] = (m, fetch_to_host(s.state_dict()))
    out["fsdp_sharded"] = {k: tuple(v.to_local().shape) for k, v in s.state_dict().items()
                           if hasattr(v, "to_local")}
    dcp_io.save_train_state(spec["ckpt_2ranks"], 1, s.state_dict())  # sharded, 2 ranks
    back = t.init_state(torch.Generator().manual_seed(1))  # other weights, then the checkpoint
    sd, _ = dcp_io.restore_train_state(spec["ckpt_1rank"], back.state_dict())
    back.load_state_dict(sd)
    out["restored_1to2"] = fetch_to_host(back.state_dict())

    real = data_parallel.all_reduce_sum
    data_parallel.all_reduce_sum = local_moments
    _, s, m = gan_step(spec, mesh)
    data_parallel.all_reduce_sum = real
    out["gan_local_bn"] = (m, fetch_to_host(s.state_dict()))
    real = gan_losses._discriminator_loss_dp
    gan_losses._discriminator_loss_dp = local_pairs(real)
    _, s, m = gan_step(spec, mesh)
    gan_losses._discriminator_loss_dp = real
    out["gan_local_pairs"] = (m, fetch_to_host(s.state_dict()))

    for tag, drop in (("damsm_dp", 0.5), ("damsm_dp_nodrop", 0.0)):
        t = DAMSMTrainer(spec["damsm_cfg"], spec["vocab"], use_inception=False, device="cpu",
                         mesh=mesh)
        s = t.init_state(torch.Generator().manual_seed(0))
        t.load_state(s, spec["damsm_text_sd"], spec["damsm_cnn_sd"])
        s.text.drop_prob = drop
        m = t.train_step(s, t.device_batch(spec["damsm_batch"]), spec["damsm_lr"])
        out[tag] = ({k: float(v) for k, v in m.items()}, damsm_readout(t, s))
    if rank == 0:
        torch.save(out, spec["out"])
    dist.barrier()
    dist.destroy_process_group()


def damsm_readout(t, s):
    """The DAMSM state whole on the CPU: both encoders' state dicts and
    Adam's moments by trainable name."""
    named = dict(t.trainable(s.text, s.cnn))
    return {"text": fetch_to_host(s.text.state_dict()), "cnn": fetch_to_host(s.cnn.state_dict()),
            "mu": {n: s.opt.state[p]["exp_avg"].clone() for n, p in named.items()},
            "nu": {n: s.opt.state[p]["exp_avg_sq"].clone() for n, p in named.items()}}


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
