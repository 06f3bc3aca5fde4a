"""The batch-variance probe (`tgsr_tpu_torch.probes.batch_variance`) on the
CPU at a small x8 geometry (BASE_SIZE 8, GF_DIM 8, T 6): its readings are
repeatable, the two witnesses trace the same module calls, and a forward
that parts has an origin where it starts."""

import torch

from tgsr_tpu_torch.probes import batch_variance as bv
from tests.torch_parity import configs


def test_batch_variance_probe_on_the_cpu():
    torch.set_num_threads(1)
    res = bv.main(device="cpu", seeds=(0,), draws=1, cfg=configs()[1],
                  paths=("float32", "int8"))
    assert res["geometry"] == {"BRANCH_NUM": 4, "BASE_SIZE": 8, "GF_DIM": 8, "imsize": 64}
    for path in ("float32", "int8"):
        got = res["seeds"]["0"][path]
        assert got["repeatable"]
        assert sorted(got["readings"]) == [str(b) for b in bv.BATCHES]
        for b, r in got["readings"].items():
            assert r["requests"] == int(b) and 0 <= r["requests_differ"] <= r["requests"]
            assert (r["max_levels"] == 0) == (r["values_differ"] == 0)
        w, wt = got["witness"], got["witness_text_per_row"]
        assert w["calls"] == wt["calls"] > 0
        for one in (w, wt):
            assert (one["calls_parted"] > 0) == (one["n_origins"] > 0)
        assert all(o["module"] != "text_encoder" for o in wt["origins"])
