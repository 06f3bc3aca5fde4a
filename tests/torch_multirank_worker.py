"""One rank of the port's multi-rank serving tests (tests/test_torch_mesh_serving.py,
test_torch_spatial.py, test_torch_pipeline_parallel.py): run as
`python tests/torch_multirank_worker.py SPEC RANK WORLD PORT` from the repository
root (gloo on the CPU, one thread). SPEC (a torch.save'd dict) holds "jobs", each
a dict with a "kind"; every rank writes what each job gave, in order, to SPEC's
"out" + ".RANK". Imports torch and the port only.

Kinds: "mesh" (an SRPipeline built with `mesh=`: its `__call__`, `forward_scan`
and `sr_batched` on the job's inputs), "plan" (`plan_microbatch` and
`sr_batched` with no microbatch, each rank's own plan the job's "plans"[rank],
then a plan that fails on rank 1 alone), "spatial" (`sr_spatial` over the mesh),
"pipeline" (`pipeline_apply` of a ResBlock chain, stages and microbatches as
given) and "raises" (the call named, its exception's type and message)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.func import functional_call  # noqa: E402

from tgsr_tpu_torch.engine.inference import SRPipeline  # noqa: E402
from tgsr_tpu_torch.ops.blocks import ResBlock  # noqa: E402
from tgsr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tgsr_tpu_torch.parallel.pipeline import make_stage_mesh, pipeline_apply  # noqa: E402

torch.set_num_threads(1)


def pipe_of(job, mesh=None):
    return SRPipeline(job["cfg"], job["vocab"], *job["sds"], device="cpu", mesh=mesh,
                      **job.get("kw", {}))


def outputs(out):
    return {k: out[k] for k in ("sr", "pyramid", "attn") if k in out}


def run_pipeline(job):
    block = ResBlock(job["ch"]).eval()
    mesh = make_stage_mesh(job["stages"], device="cpu")
    if mesh.get_coordinate() is None:
        return None  # this rank is not on the stage mesh
    return pipeline_apply(lambda v, h: functional_call(block, v, (h,)), job["stacked"],
                          job["x"], mesh, n_micro=job["n_micro"])


def run(job, mesh):
    kind = job["kind"]
    if kind == "mesh":
        pipe = pipe_of(job, mesh)
        lr, cap, lens = job["inputs"]
        lr_u8, m = torch.from_numpy(job["lr_u8"]), job["scan_m"]
        with torch.inference_mode():
            return {"call": outputs(pipe(lr, cap, lens)),
                    "scan": pipe.forward_scan(lr_u8[None].repeat(m, 1, 1, 1, 1),
                                              cap[None].repeat(m, 1, 1), lens[None].repeat(m, 1)),
                    "batched": torch.from_numpy(pipe.sr_batched(
                        job["lr_u8"], cap, lens, microbatch=job["microbatch"]))}
    if kind == "plan":
        pipe = pipe_of(job, mesh)
        rank = dist.get_rank()
        pipe._local_microbatch = lambda *a: job["plans"][rank]
        cap, lens = job["inputs"][1:]
        with torch.inference_mode():
            out = {"plan": pipe.plan_microbatch(),
                   "batched": torch.from_numpy(pipe.sr_batched(job["lr_u8"], cap, lens))}

        def fails(*a):
            if rank == 1:
                raise RuntimeError("no microbatch of at least 1 fits")
            return job["plans"][rank]

        pipe._local_microbatch = fails
        try:
            pipe.plan_microbatch()
        except RuntimeError as e:
            out["fault"] = str(e)
        return out
    if kind == "spatial":
        return outputs(pipe_of(job).sr_spatial(*job["inputs"], mesh=mesh))
    if kind == "pipeline":
        return run_pipeline(job)
    if kind == "raises":
        try:
            if job["call"] == "pipeline":
                run_pipeline(job)
            elif job["call"] == "stage_mesh":
                make_stage_mesh(job["stages"], device="cpu")
            else:
                pipe_of(job).sr_spatial(*job["inputs"], mesh=mesh)
        except Exception as e:  # noqa: BLE001 -- the test reads the type and the message
            return (type(e).__name__, str(e))
        return None
    raise ValueError(kind)


def start(jobs, world, root):
    """Launch `world` ranks on `jobs` (a list of job dicts) under the
    directory `root`; returns the handle `finish` takes. The caller's own
    work runs while they do."""
    import subprocess

    from tgsr_tpu_torch.parallel.multihost import free_port

    spec = {"jobs": jobs, "out": os.path.join(str(root), f"out{world}")}
    spec_path = os.path.join(str(root), f"spec{world}.pt")
    torch.save(spec, spec_path)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, spec_path, str(r), str(world), str(port)],
                              cwd=os.path.dirname(os.path.dirname(here)), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    return procs, spec["out"]


def finish(handle, timeout=300):
    """Every rank's results: [rank][job]."""
    procs, out = handle
    for p in procs:
        log = p.communicate(timeout=timeout)[0].decode()
        assert p.returncode == 0, log[-3000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(len(procs))]


def main(spec_path, rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(world, 1, device="cpu")
    results = [run(job, mesh) for job in spec["jobs"]]
    torch.save(results, f"{spec['out']}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
