"""Ranky-GaLore and the spectral diagnostics of the port against the JAX
package, on the CPU.

GaLore's randomness is an input: the repair columns of a step are the
reference's own draws (``jax.random.split(key, leaves)`` in its leaf
order, ``randint`` per leaf), injected by path.  The eigh basis carries a
sign per column: one refresh period is sign-invariant (P^T g, m, v and
P d flip together), so a refresh step is compared on the parameters and
on the subspace P P^T, and a step across a refresh is given the
reference's P.  Inputs from a seed with numpy, float32.  Tolerances: the
subspace 1e-4; parameters rtol 1e-5 with atol 1e-6 * max; moments 1e-5 of
max (float32 sums in another order, eigh by another LAPACK call).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.compression import galore as jgalore
from repro.core import spectral as jspectral
from repro.optim import adamw as jadamw

from repro_torch.compression import galore as tgalore
from repro_torch.configs import base as tbase
from repro_torch.core import spectral as tspectral
from repro_torch.data import tokens as ttokens
from repro_torch.models import schema as tschema
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import tree
from repro_torch.train import step as tstep

from test_torch_helpers import one_torch_thread, projector_gap  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _grads(seed=0):
    """A stacked leaf with structurally zero rows in one slice, a tall and
    a wide matrix (eligible), a short matrix and a vector (not)."""
    rng = np.random.default_rng(seed)
    stacked = rng.standard_normal((3, 96, 80)).astype(np.float32)
    stacked[1, 70:] = 0.0
    return {"attn": {"wq": stacked,
                     "norm": rng.standard_normal(80).astype(np.float32)},
            "tall": rng.standard_normal((160, 72)).astype(np.float32),
            "wide": rng.standard_normal((66, 200)).astype(np.float32),
            "short": rng.standard_normal((8, 100)).astype(np.float32)}


def _reference_cols(key, params, gcfg):
    """{path: the reference's repair columns} of one step's ``key``."""
    flat = tree.flatten(params)
    keys = jax.random.split(key, len(flat))
    out = {}
    for (path, p), k in zip(flat, keys):
        if tgalore.eligible(gcfg, p):
            m, n = p.shape[-2:]
            out[path] = torch.from_numpy(np.array(
                jax.random.randint(k, (m,), 0, n))).long()
    return out


def test_basis_subspace_given_the_references_draws():
    gcfg = tgalore.GaloreConfig(rank=8, min_dim=32)
    g = _grads()["attn"]["wq"]
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(jax.vmap(lambda gm: jgalore._basis(
        jgalore.GaloreConfig(rank=8, min_dim=32), gm, key)))(jnp.asarray(g)))
    cols = torch.from_numpy(np.array(jax.random.randint(key, (96,), 0, 80)))
    got = tgalore.mesh_basis(gcfg, torch.from_numpy(g), cols=cols).numpy()
    assert got.shape == want.shape == (3, 96, 8)
    for i in range(3):
        assert projector_gap(got[i], want[i]) < 1e-4
        np.testing.assert_allclose(got[i].T @ got[i], np.eye(8), atol=1e-5)


def test_galore_steps_match_the_reference():
    """A refresh step given the reference's draws (parameters and moments
    up to the basis signs, the subspace), then a step across the period
    given the reference's P (and moments): the same update."""
    jgcfg = jgalore.GaloreConfig(rank=8, update_every=2, min_dim=32)
    tgcfg = tgalore.GaloreConfig(rank=8, update_every=2, min_dim=32)
    jacfg = jadamw.AdamWConfig(lr=1e-2)
    tacfg = tadamw.AdamWConfig(lr=1e-2)
    params = _grads(1)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    jst, tst = jgalore.init_state(jp, jgcfg), tgalore.init_state(tp, tgcfg)
    japply = jax.jit(lambda p_, g_, s_, k_: jgalore.apply_updates(
        jacfg, jgcfg, p_, g_, s_, lr_scale=0.5, key=k_))
    for i in range(3):
        g = _grads(10 + i)
        key = jax.random.PRNGKey(100 + i)
        jp, jst, jm = japply(jp, jax.tree.map(jnp.asarray, g), jst, key)
        tp, tst, tm = tgalore.apply_updates(
            tacfg, tgcfg, tp, tree.tree_map(torch.from_numpy, g), tst,
            lr_scale=0.5, cols=_reference_cols(key, tp, tgcfg))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        for (path, got), want in zip(tree.flatten(tp), jax.tree.leaves(jp)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {i} {path}")
        jleaves = jst["leaves"]
        for path, p in tree.flatten(tp):
            st = tgalore._leaf_state(tst["leaves"], path)
            ref = jleaves
            for part in path.split("/"):
                ref = ref[part]
            if "p" in st:
                for j in np.ndindex(st["p"].shape[:-2]):
                    assert projector_gap(st["p"][j].numpy(),
                                         np.asarray(ref["p"][j])) < 1e-4
                # the reference's basis (and moments, in its signs) carried
                # over, so that the next period starts from the same P
                for k in ("p", "m", "v"):
                    st[k].copy_(torch.from_numpy(np.array(ref[k])))
            else:
                for k in ("m", "v"):
                    np.testing.assert_allclose(
                        st[k].numpy(), np.asarray(ref[k]), rtol=0,
                        atol=1e-5 * np.abs(np.asarray(ref[k])).max())
    assert int(tst["step"]) == int(jst["step"]) == 3


def test_galore_state_smaller_than_adamw():
    """The twin of tests/test_substrate.py's, and the state's bytes equal
    the reference's leaf by leaf."""
    params = {"w": torch.zeros((256, 512)), "b": torch.zeros((256,))}
    gcfg = tgalore.GaloreConfig(rank=16, min_dim=64)
    gstate = tgalore.init_state(params, gcfg)
    full = 2 * (256 * 512 + 256) * 4
    assert tgalore.state_bytes(gstate) < 0.3 * full
    jstate = jgalore.init_state(
        {"w": jnp.zeros((256, 512)), "b": jnp.zeros((256,))},
        jgalore.GaloreConfig(rank=16, min_dim=64))
    assert tgalore.state_bytes(gstate) == jgalore.state_bytes(jstate)
    adam = tadamw.init_state(params)
    assert tgalore.state_bytes(gstate) < sum(
        x.numel() * x.element_size() for x in tree.leaves(
            {"m": adam["m"], "v": adam["v"]}))


def test_galore_reduces_loss():
    """The twin of tests/test_substrate.py's least-squares case."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    w_true = torch.from_numpy(
        rng.standard_normal((64, 128)).astype(np.float32))
    y = x @ w_true
    params = {"w": torch.zeros((64, 128))}
    gcfg = tgalore.GaloreConfig(rank=16, update_every=10, min_dim=32)
    acfg = tadamw.AdamWConfig(lr=3e-2, weight_decay=0.0)
    state = tgalore.init_state(params, gcfg)

    def loss_fn(w):
        return torch.mean((x @ w - y) ** 2)

    l0 = float(loss_fn(params["w"]))
    for i in range(100):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn(w), [w])
        params, state, _ = tgalore.apply_updates(acfg, gcfg, params,
                                                 {"w": g}, state, seed=i)
    assert float(loss_fn(params["w"])) < 0.3 * l0


def test_galore_basis_stable_with_repair():
    """The twin of tests/test_substrate.py's: 24 structurally zero rows,
    the same draws give the same basis, spanning the non-zero rows."""
    rng = np.random.default_rng(0)
    g = np.zeros((32, 64), np.float32)
    g[:8] = rng.standard_normal((8, 64))
    gcfg = tgalore.GaloreConfig(rank=8, repair=True)
    cols = tgalore.draw_cols(0, 0, 32, 64)
    p1 = tgalore.mesh_basis(gcfg, torch.from_numpy(g), cols=cols).numpy()
    p2 = tgalore.mesh_basis(gcfg, torch.from_numpy(g), cols=cols).numpy()
    np.testing.assert_allclose(p1, p2, atol=1e-6)
    np.testing.assert_allclose(p1 @ p1.T @ g, g, atol=1e-3)
    assert torch.equal(cols, tgalore.draw_cols(0, 0, 32, 64))
    assert not torch.equal(cols, tgalore.draw_cols(0, 1, 32, 64))


def test_train_step_with_galore_runs():
    """The twin of tests/test_substrate.py's, on the port's trainer: a
    refresh at step 0, finite loss, state below AdamW's."""
    cfg = tbase.get_smoke_config("phi4-mini-3.8b")
    tcfg = tstep.TrainConfig(optimizer="galore", remat="none",
                             galore=tgalore.GaloreConfig(rank=8, min_dim=32))
    state = tstep.init_train_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0), "cpu")
    before = tree.tree_map(lambda p: p.clone(), state["params"])
    step = tstep.make_train_step(cfg, tcfg)
    dcfg = ttokens.DataConfig(cfg.vocab_size, 32, 4)
    batch = ttokens.shard_batch(ttokens.batch_at(dcfg, 0), "cpu")
    for i in range(2):         # the warmup's lr is 0 at step 0
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert set(metrics) == {"loss", "aux_loss", "grad_norm", "lr_scale"}
    moved = [not torch.equal(a, b) for a, b in zip(
        tree.leaves(before), tree.leaves(state["params"]))]
    assert all(moved)
    adam = tstep.init_opt_state(dataclasses.replace(tcfg, optimizer="adamw"),
                                state["params"])
    assert tgalore.state_bytes(state["opt"]) < sum(
        x.numel() * 4 for x in tree.leaves({"m": adam["m"], "v": adam["v"]}))


# ---------------------------------------------------------------------------
# Spectral diagnostics: the twins of tests/test_spectral.py
# ---------------------------------------------------------------------------

def test_matrix_spectrum_matches_numpy_and_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 160)).astype(np.float32)
    s = tspectral.matrix_spectrum(torch.from_numpy(w), top_k=8).numpy()
    np.testing.assert_allclose(
        s, np.linalg.svd(w, compute_uv=False)[:8], rtol=1e-3)
    np.testing.assert_allclose(
        s, np.asarray(jspectral.matrix_spectrum(jnp.asarray(w), top_k=8)),
        rtol=1e-5)


def test_matrix_spectrum_batched_and_tall():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 200, 64)).astype(np.float32)
    s = tspectral.matrix_spectrum(torch.from_numpy(w), top_k=4).numpy()
    assert s.shape == (3, 4)
    for i in range(3):
        np.testing.assert_allclose(
            s[i], np.linalg.svd(w[i], compute_uv=False)[:4], rtol=1e-3)


def test_effective_rank_limits():
    assert float(tspectral.effective_rank(torch.ones(8))) > 7.9
    spike = torch.tensor([1.0] + [1e-9] * 7)
    assert float(tspectral.effective_rank(spike)) < 1.1
    s = torch.tensor([[3.0, 2.0, 0.5, 0.0], [1.0, 1.0, 0.0, 0.0]])
    np.testing.assert_allclose(
        tspectral.effective_rank(s).numpy(),
        np.asarray(jspectral.effective_rank(jnp.asarray(s.numpy()))),
        rtol=1e-6)


def test_tree_spectra_on_model_match_reference():
    cfg = tbase.get_smoke_config("phi4-mini-3.8b")
    params = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rep = tspectral.tree_spectra(params, top_k=4)
    assert any("w_up" in k for k in rep) and any("embed" in k for k in rep)
    want = jax.jit(lambda p: jspectral.tree_spectra(p, top_k=4))(
        jax.tree.map(lambda p: jnp.asarray(p.numpy()), params))
    assert set(rep) == set(want)
    for name, d in rep.items():
        for key in ("top", "erank", "fro"):
            np.testing.assert_allclose(d[key].numpy(),
                                       np.asarray(want[name][key]),
                                       rtol=1e-4, err_msg=f"{name} {key}")
    lowrank = {"w": torch.outer(torch.ones(64), torch.ones(64))}
    assert float(tspectral.tree_spectra(lowrank, top_k=8)["w"]["erank"]) \
        < 1.1
    text = tspectral.summarize(rep)
    assert text.splitlines()[0].startswith(sorted(rep)[0])
    assert "sigma1=" in text and "erank(mean)=" in text
    hook = tspectral.spectra_hook({"params": params}, top_k=4,
                                  include_grads=params)
    assert set(hook) == {"params", "grads"}
