"""A run drives the timed path with a fault planted underneath and must
come out not correct: a step that returns its state unchanged, half of
the batch left out (the rest scaled to stand for it), an answer altered
where it is produced, in its leading direction or in a later one, and,
in a cell that repairs lonely rows, some of the repair's picks altered.  (One
card: no exchange between chips to leave out.)  Each run skips the look
for a card and is the harness's own, at a small size on the CPU."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.tests import helpers


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _half_the_blocks(ell, vals):
    """The batch with its first half of column blocks left out and the
    rest scaled so that the gram keeps its size."""
    vals = vals.clone()
    half = vals.shape[0] // 2
    vals[:half] = 0.0
    vals[half:] *= 2.0 ** 0.5
    return vals


def _solve_faults():
    from repro_torch.core import api, randomized, ranky, sparse
    from repro_torch.core import svd as lsvd

    real_repair = ranky.split_and_repair

    def half_repair(a, *args, **kw):
        rep = real_repair(a, *args, **kw)
        ell = dataclasses.replace(
            rep.ell, col_vals=_half_the_blocks(rep.ell, rep.ell.col_vals))
        return sparse.RepairedSparseBlocks(ell, rep.repair_cols,
                                           rep.repair_mask)

    real_run = api._run_single
    first = {}

    def unchanged(a, cfg, **kw):
        if "out" not in first:
            first["out"] = real_run(a, cfg, **kw)
        return first["out"]

    real_eigh = lsvd.merge_grams_eigh

    def altered_eigh(grams):
        u, s = real_eigh(grams)
        return u, s * torch.where(torch.arange(s.shape[0]) == 0, 1.01, 1.0)

    real_trunc = randomized.truncate_sketch

    def altered_sketch(t, h, rank):
        u, s, vproj = real_trunc(t, h, rank)
        return u, s * 1.01, vproj

    def later_eigh(grams):
        u, s = real_eigh(grams)
        return u[..., [0, 2, 1] + list(range(3, u.shape[-1]))], s

    def later_sketch(t, h, rank):
        u, s, vproj = real_trunc(t, h, rank)
        return u, s, torch.cat([vproj[..., :-1], -vproj[..., -1:]], -1)

    def picks_altered(every, most=None):
        """The repair with the pick of every ``every``-th repaired row
        (counted over the blocks in turn, from the first; at most
        ``most``) moved one column on inside its block."""
        def altered(a, *args, **kw):
            rep = real_repair(a, *args, **kw)
            which = torch.nonzero(rep.repair_mask.flatten()).squeeze(1)
            which = which[::every][:most]
            cols = rep.repair_cols.clone().flatten()
            cols[which] = (cols[which] + 1) % rep.ell.width
            return sparse.RepairedSparseBlocks(
                rep.ell, cols.view_as(rep.repair_cols), rep.repair_mask)
        return altered

    return {
        "half of the batch": [(ranky, "split_and_repair", half_repair)],
        "state unchanged": [(api, "_run_single", unchanged)],
        "answer altered": [(lsvd, "merge_grams_eigh", altered_eigh),
                           (randomized, "truncate_sketch", altered_sketch)],
        # U's second and third directions swapped (V follows U), or V's
        # last direction turned over: S stays right.
        "a later direction altered": [
            (lsvd, "merge_grams_eigh", later_eigh),
            (randomized, "truncate_sketch", later_sketch)],
        "a third of the picks altered": [
            (ranky, "split_and_repair", picks_altered(3))],
        "one pick altered": [
            (ranky, "split_and_repair", picks_altered(1, most=1))],
    }


CASES = [(cell, fault) for cell in ("sparse-2048x1m.exact",
                                    "sparse-2048x1m.rank16",
                                    "ranky-paper.exact")
         for fault in ("half of the batch", "state unchanged",
                       "answer altered", "a later direction altered")] + [
    ("ranky-paper.exact", fault) for fault in (
        "a third of the picks altered", "one pick altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    """Set-up runs sound; the fault is planted as the window opens."""
    from perfbench import spec

    faults = _solve_faults()
    traffic = spec.traffic(helpers.tiny(cell)["workload"])
    real_window = traffic.window

    def broken_window(ctx, st):
        for module, name, fake in faults[fault]:
            monkeypatch.setattr(module, name, fake)
        return real_window(ctx, st)

    monkeypatch.setattr(traffic, "window", broken_window)
    out = helpers.run_tiny(cell)
    assert not out["correct"], out["checks"]
