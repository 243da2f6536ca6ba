"""The port's launch tools on the CPU, twins of ``tests/test_launch.py``:
the cost counter (``launch/hlocost.py``), the H100 roofline
(``launch/roofline.py``), the production mesh (``launch/mesh.py``), the
two LM kernels' ``meta`` branches and the dry run (``launch/dryrun.py``).

FLOPs parity with the reference's HLO walker on ``prefill_forward`` at
2 x 512, full width, every config (the reference compiled on one CPU
device with ``REPRO_KERNELS=ref``, set in this process for it alone).  The
port charges ``flash_attention`` its visible (query, key) pairs, where the
reference's plain attention computes every pair and masks; so the port's
count plus the masked pairs (4 d a pair and query head) is held within 3 %
of the reference's, and its own count between 0.94 and 1 of it (qwen2-vl
pads 12 heads to 48, so its masked half is 4.6 % of the total).  The two
scan configs within 5 %: the port charges ``ssd_scan`` its closed form
(4 P N a step and head), the reference's scan is its plain jnp scan
(measured 1.1 % and 0.8 % apart).  The train step at smoke width, remat
``"none"``: phi4-mini within 3 %; zamba2 within 15 %, because the ssd
backward recomputes the chunked scan under autograd (its Q x Q products
per chunk), where the reference differentiates its plain scan (measured
+12.4 %).
"""
import os
import types

import numpy as np
import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.ft.elastic import plan_mesh as jplan_mesh
from repro.launch import hlocost as jhlocost
from repro.launch import roofline as jroofline
from repro.models.io import train_batch as jtrain_batch
from repro.models.layers import ShardCtx as JShardCtx
from repro.models.schema import abstract_params as jabstract_params
from repro.models.transformer import prefill_forward as jprefill_forward
from repro.train import step as jstep

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun, hlocost, roofline
from repro_torch.launch.mesh import CountingMesh, make_host_mesh, \
    make_production_mesh
from repro_torch.models.io import train_batch
from repro_torch.models.schema import abstract_params
from repro_torch.models.transformer import prefill_forward
from repro_torch.train import step as tstep

from test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCAN_ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def test_chained_matmuls_cost_ten_times_one():
    """Ten matmuls in a Python loop, and 4 x 5 nested, cost 10 (20) times
    one, within 10 %: every op run is counted once, nothing is a loop body
    counted once."""
    x, w = _meta(128, 256), _meta(256, 256)

    def chain(x, w):
        for _ in range(10):
            x = x @ w
        return x

    def nested(x, w):
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x

    one = 2 * 128 * 256 * 256
    assert 10 * one <= hlocost.analyze(chain, x, w).flops <= 10 * one * 1.1
    x2, w2 = _meta(64, 64), _meta(64, 64)
    want = 2 * 64 ** 3 * 20
    assert want <= hlocost.analyze(nested, x2, w2).flops <= want * 1.1


@pytest.mark.parametrize("how", ["copy_into_slice", "index_copy_",
                                 "index_put_"])
def test_slice_writes_cost_the_slice_not_the_buffer(how):
    """A loop writing slices into a (64, 128, 128) buffer costs less than
    0.2 of the whole buffer read and written per step."""
    def f(x):
        buf = torch.zeros((64, 128, 128), device="meta")
        for i in range(64):
            upd = x * (i + 1.0)
            idx = torch.full((1,), i, dtype=torch.int64, device="meta")
            if how == "copy_into_slice":
                buf[i] = upd
            elif how == "index_copy_":
                buf.index_copy_(0, idx, upd[None])
            else:
                buf.index_put_((idx,), upd[None])
        return buf

    cost = hlocost.analyze(f, _meta(128, 128))
    whole_buffer_per_step = 64 * (64 * 128 * 128 * 4) * 2
    assert 0 < cost.bytes < 0.2 * whole_buffer_per_step


def test_views_and_empties_move_nothing_and_peak_is_tracked():
    x = _meta(1024, 1024)

    def f(x):
        y = x.view(-1).reshape(1024, 1024).t()
        z = torch.empty_like(y)
        del z
        a = x + 1.0
        b = a * 2.0
        del a
        return b

    cost = hlocost.analyze(f, x)
    assert cost.bytes == 2 * (2 * 1024 * 1024 * 4)   # read x, write y
    assert cost.flops == 2 * 1024 * 1024
    # empty_like, then a and b alive together: 2 buffers at most
    assert cost.peak_bytes == 2 * 1024 * 1024 * 4


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

def test_roofline_terms_and_bottleneck():
    r = roofline.Roofline(
        arch="a", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops_per_chip=989e12,           # exactly 1 s of compute
        hlo_bytes_per_chip=3.35e12 * 0.5,    # 0.5 s of HBM
        collective_bytes_per_chip=50e9 * 2.0,  # 2 s on the link
        model_flops=989e12 * 256 * 0.5)
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.useful_flop_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.25)
    assert set(r.row()) == set(jroofline.Roofline(
        "a", "s", "m", 1, 1.0, 1.0, 1.0, 1.0).row())


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-235b-a22b",
                                  "zamba2-2.7b"])
def test_model_flops_equal_the_references(arch):
    for shape in tbase.SHAPES:
        assert roofline.model_flops(tbase.get_config(arch),
                                    tbase.SHAPES[shape]) == \
            jroofline.model_flops(jbase.get_config(arch),
                                  jbase.SHAPES[shape])


def test_moe_uses_active_params():
    cfg = tbase.get_config("qwen3-moe-235b-a22b")
    f = roofline.model_flops(cfg, tbase.SHAPES["train_4k"])
    assert f < 6 * cfg.param_count() * 4096 * 256 * 0.2
    assert f == pytest.approx(6 * cfg.active_param_count() * 4096 * 256)


def test_cells_assignment():
    assert sum(len(tbase.cells(a)) for a in tbase.ARCH_IDS) == 32
    assert "long_500k" in tbase.cells("mamba2-1.3b")
    assert "long_500k" in tbase.cells("zamba2-2.7b")
    assert "long_500k" not in tbase.cells("gemma2-9b")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_production_mesh_shapes():
    """One slot of (16, 16) and (2, 16, 16), the reference's axis names
    (its planner's, which touches no device state); the collectives check
    their input and return meta results."""
    for multi, n in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi)
        want = jplan_mesh(n, model_parallel=16, multi_pod_threshold=512)
        assert tuple(mesh.shape.values()) == want.shape
        assert mesh.axis_names == want.axis_names
        assert mesh.n_local == 1 and mesh.device.type == "meta"
    mesh = make_production_mesh()
    with hlocost.Counter() as c:
        out = mesh.all_gather(_meta(1, 3, 5), ("model",))
        red = mesh.psum(_meta(1, 7), ("data",))
    assert out.shape == (1, 16, 3, 5) and red.shape == (1, 7)
    assert c.cost.collective == {"all-gather": 16 * 15 * 4,
                                 "all-reduce": 7 * 4}
    with pytest.raises(ValueError, match="one slot"):
        mesh.psum(_meta(2, 7), ("data",))
    with pytest.raises(ValueError, match="meta"):
        mesh.psum(torch.zeros(1, 7), ("data",))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.psum(_meta(1, 7), ("pod",))
    with pytest.raises(ValueError, match="slot"):
        CountingMesh({"data": 2}, slot=2)
    host = make_host_mesh(2, "cpu")
    assert host.shape == {"data": 1, "model": 1}


# ---------------------------------------------------------------------------
# the two kernels' meta branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("causal, window", [(True, 0), (True, 5),
                                            (False, 0), (False, 3)])
def test_flash_meta_branch_shapes_and_charge(grad, causal, window):
    """On meta: the CPU branch's output (and ``lse``) shapes and dtypes,
    one charge of exactly ``work`` and nothing else in the forward; the
    visible pairs are the mask's."""
    shapes = dict(q=(2, 4, 9, 16), k=(2, 2, 12, 16))
    for dtype in (torch.float32, torch.bfloat16):
        cpu = {n: torch.randn(s).to(dtype).requires_grad_(grad)
               for n, s in shapes.items()}
        meta = {n: _meta(*s, dtype=dtype).requires_grad_(grad)
                for n, s in shapes.items()}
        want = fa.flash_attention(cpu["q"], cpu["k"], cpu["k"],
                                  causal=causal, window=window)
        with hlocost.Counter() as c:
            got = fa.flash_attention(meta["q"], meta["k"], meta["k"],
                                     causal=causal, window=window)
        assert got.shape == want.shape and got.dtype == want.dtype
        b, hq, sq, d = shapes["q"]
        nbytes, flops = fa.work(b, hq, 2, sq, 12, d, want.element_size(),
                                causal=causal, window=window, lse=grad)
        assert c.cost.kernel_calls == {"flash_attention": 1}
        assert c.cost.flops == flops and c.cost.bytes == nbytes
        out, lse = fa._meta(meta["q"], meta["k"], causal, window, True)
        ref_out, ref_lse = fa._forward(cpu["q"].detach(), cpu["k"].detach(),
                                       cpu["k"].detach(), causal, window,
                                       0.0, d ** -0.5, True)
        assert lse.shape == ref_lse.shape and lse.dtype == ref_lse.dtype
    mask = fa._mask(9, 0, 12, 12, causal, window, "cpu")
    assert fa.visible_pairs(9, 12, causal, window) == int(mask.sum())


@pytest.mark.parametrize("grad", [False, True])
def test_ssd_meta_branch_shapes_and_charge(grad):
    b, seq, h, g, p, n = 2, 10, 4, 2, 8, 4
    shapes = dict(x=(b, seq, h, p), dt=(b, seq, h), a=(h,),
                  bm=(b, seq, g, n), cm=(b, seq, g, n))
    for dtype in (torch.float32, torch.bfloat16):
        def make(dev):
            return {k: (torch.randn(s) if dev == "cpu" else _meta(*s)).to(
                torch.float32 if k == "a" else dtype).requires_grad_(grad)
                for k, s in shapes.items()}
        cpu, meta = make("cpu"), make("meta")
        want = ss.ssd_scan(*cpu.values())
        with hlocost.Counter() as c:
            got = ss.ssd_scan(*meta.values())
        for x, y in zip(got, want):
            assert x.shape == y.shape and x.dtype == y.dtype
        nbytes, flops = ss.work(b, seq, h, g, p, n,
                                torch.empty((), dtype=dtype).element_size())
        assert c.cost.kernel_calls == {"ssd_scan": 1}
        assert c.cost.flops == flops and c.cost.bytes == nbytes


def test_other_devices_still_raise():
    """Meta is a branch of its own; a device that is neither the CPU, meta
    nor CUDA still raises."""
    fake = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        fa._forward(fake, None, None, True, 0, 0.0, 1.0, False)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ss._forward(fake, None, None, None, None)


# ---------------------------------------------------------------------------
# FLOPs parity with the reference
# ---------------------------------------------------------------------------

def _reference_prefill_flops(arch, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    cfg = jbase.get_config(arch)
    batch = jtrain_batch(cfg, 2, 512, abstract=True)
    batch.pop("labels", None)
    txt = jax.jit(lambda p, b: jprefill_forward(cfg, p, b, JShardCtx())) \
        .lower(jabstract_params(cfg), batch).compile().as_text()
    return jhlocost.analyze(txt).flops


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_prefill_flops_match_the_references(arch, monkeypatch):
    cfg = tbase.get_config(arch)
    params = abstract_params(cfg)
    batch = train_batch(cfg, 2, 512, abstract=True)
    batch.pop("labels")
    masked = []
    work = fa.work

    def spy(b, hq, hkv, sq, sk, d, itemsize, *, causal=True, window=0,
            lse=False):
        masked.append(4.0 * b * hq * d * (
            sq * sk - fa.visible_pairs(sq, sk, causal, window)))
        return work(b, hq, hkv, sq, sk, d, itemsize, causal=causal,
                    window=window, lse=lse)

    monkeypatch.setattr(fa, "work", spy)
    with torch.no_grad():
        cost = hlocost.analyze(lambda: prefill_forward(cfg, params, batch))
    want = _reference_prefill_flops(arch, monkeypatch)
    ratio = cost.flops / want
    like_for_like = (cost.flops + sum(masked)) / want
    if arch in SCAN_ARCHS:
        assert cost.kernel_calls["ssd_scan"] >= 1
        assert abs(like_for_like - 1) <= 0.05, (ratio, like_for_like)
    else:
        assert abs(like_for_like - 1) <= 0.03, (ratio, like_for_like)
        assert 0.94 <= ratio <= 1.0, ratio
    assert cost.kernel_calls.get("flash_attention", 0) == len(masked)
    assert len(masked) >= 1 or arch == "mamba2-1.3b"


@pytest.mark.parametrize("arch, rel", [("phi4-mini-3.8b", 0.03),
                                       ("zamba2-2.7b", 0.15)])
def test_train_step_flops_match_the_references(arch, rel, monkeypatch):
    """The AdamW step at smoke width, 2 x 64, remat "none"."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg = jbase.get_smoke_config(arch)
    jtc = jstep.TrainConfig(remat="none")
    txt = jax.jit(jstep.make_train_step(jcfg, jtc, JShardCtx())).lower(
        jstep.abstract_train_state(jcfg, jtc),
        jtrain_batch(jcfg, 2, 64, abstract=True)).compile().as_text()
    want = jhlocost.analyze(txt).flops
    cfg = tbase.get_smoke_config(arch)
    tc = tstep.TrainConfig(remat="none")
    params = abstract_params(cfg)
    state = {"params": params, "opt": tstep.init_opt_state(tc, params),
             "seed": 1}
    cost = hlocost.analyze(tstep.make_train_step(cfg, tc), state,
                           train_batch(cfg, 2, 64, abstract=True))
    assert abs(cost.flops / want - 1) <= rel, cost.flops / want


# ---------------------------------------------------------------------------
# the dry run: two production cells on 16 x 16
# ---------------------------------------------------------------------------

def test_dryrun_phi4_train_4k_on_the_production_mesh(capsys):
    res = dryrun.run_cell("phi4-mini-3.8b", "train_4k", multi_pod=False)
    assert res["ok"], res.get("error")
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["collective_detail"]["bytes"]["all-reduce"] > 0
    assert res["collective_detail"]["bytes"]["all-gather"] > 0
    assert 0.3 < res["useful_flop_ratio"] <= 1.05
    assert res["collective_detail"]["kernel_calls"]["flash_attention"] > 0
    mem = res["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    assert "ok" in capsys.readouterr().out


def test_dryrun_zamba2_long_500k_shards_the_sequence():
    fn, args, ctx = dryrun.lower_cell("zamba2-2.7b", "long_500k",
                                      multi_pod=False)
    params, cache, batch = args
    seq = tbase.SHAPES["long_500k"].seq_len
    assert ctx.axes("seq_shard") == ("data",) and ctx.axes("batch") is None
    assert cache["k"].shape[3] == seq // 16
    assert batch["tokens"].shape == (1, 1)
    res = dryrun.run_cell("zamba2-2.7b", "long_500k", multi_pod=False)
    assert res["ok"], res.get("error")
    assert res["collective_detail"]["counts"]["all-reduce"] > 0


def test_dryrun_cli_caches_done_cells(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dry.json"
    calls = []
    monkeypatch.setattr(dryrun, "run_cell", lambda a, s, multi_pod: (
        calls.append((a, s, multi_pod)) or {
            "arch": a, "shape": s, "mesh": dryrun._mesh_name(multi_pod),
            "ok": True}))
    args = ["--arch", "gemma2-9b", "--shape", "decode_32k",
            "--both-meshes", "--out", str(out)]
    dryrun.main(args)
    dryrun.main(args)
    assert calls == [("gemma2-9b", "decode_32k", False),
                     ("gemma2-9b", "decode_32k", True)]
    assert "2/2 cells ok" in capsys.readouterr().out
    assert os.path.exists(out)
