"""``repro_torch.core.stages``: the opt-in stage times of a solve.

Port-only (the reference's counterpart is its ``obs`` package, a later
slice), so there is nothing to compare against: held here are the stages
each path reports, that their sum stays inside the solve's wall time, and
that recording changes no result (bitwise on the CPU)."""
import pytest
import torch

from repro_torch.core import api, sparse, stages

FRONT = ["describe_and_plan", "as_block_input", "split_and_repair"]
PATHS = [
    (dict(merge_mode="gram", want_right=True, use_kernel=True),
     FRONT + ["gram_stack", "merge_grams_eigh", "right_vectors_stack"],
     {}),
    (dict(merge_mode="proxy"),
     FRONT + ["gram_stack", "eigh_to_svd", "merge_panels_svd"], {}),
    (dict(merge_mode="proxy", local_mode="svd"),
     FRONT + ["local_svd_exact", "merge_panels_svd"], {}),
    (dict(backend="single", method="random", rank=8, power_iters=2,
          want_right=True),
     FRONT + ["sketch", "pullback", "qr", "sketch_gram", "truncate_sketch",
              "right_vectors"],
     {"sketch": 3, "pullback": 3, "qr": 2}),
]


@pytest.mark.parametrize("knobs,names,repeats", PATHS)
def test_each_path_reports_its_stages_where_they_run(knobs, names, repeats):
    coo = sparse.random_bipartite(48, 4096, 2e-3, seed=1)
    cfg = api.SolveConfig(num_blocks=4, **knobs)
    plain = api.svd(coo, cfg, device="cpu")
    with stages.record() as times:
        timed = api.svd(coo, cfg, device="cpu")
    assert list(times) == names + ["diagnostics"]
    for name, runs in times.items():
        assert len(runs) == repeats.get(name, 1)
        assert all(ms >= 0.0 for ms in runs)
    # "diagnostics" runs after the solve's wall time ends.
    total_ms = sum(sum(runs) for name, runs in times.items()
                   if name != "diagnostics")
    assert total_ms <= timed.diagnostics.wall_time_s * 1e3
    assert torch.equal(plain.s, timed.s) and torch.equal(plain.u, timed.u)


def test_nothing_is_recorded_outside_record_and_record_does_not_nest():
    with stages.stage("idle"):
        pass
    with stages.record() as times:
        with stages.stage("a"):
            pass
        with pytest.raises(RuntimeError, match="does not nest"):
            with stages.record():
                pass
    assert list(times) == ["a"]
    with stages.stage("after"):
        pass
    assert list(times) == ["a"]
