"""The port's lowering, compiled plans and executor against the reference's
(``repro.primitives.{plan,executor}``) on the same weights and inputs.

Plans are held at rtol=atol=2e-3, the reference's own plan tolerance
(``tests/test_variants.py``); on the CPU every tile column's kernel runs as
its plain version, so this checks the lowering, the variant routing and the
fused epilogues end to end.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn_zoo as JZ
from repro.primitives import executor as JE
from repro.primitives import plan as JP
from repro_torch.convert import weights_from_jax
from repro_torch.models import cnn_zoo as TZ
from repro_torch.primitives import executor as TE
from repro_torch.primitives import plan as TP

PLAN_TOL = dict(rtol=2e-3, atol=2e-3)
ROOT = Path(__file__).resolve().parents[1]
_SMOKE = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)
kernel_mix_assignment = chip_smoke.kernel_mix_assignment


def pbqp_edge_cnn():
    """BENCH_executor.json -> networks.edge_cnn.tile_variant.selected_assignment
    (PBQP's tile columns for edge_cnn's convs; joins take chw)."""
    bench = json.loads((ROOT / "BENCH_executor.json").read_text())
    sel = bench["networks"]["edge_cnn"]["tile_variant"]["selected_assignment"]
    n = len(JZ.get("edge_cnn").nodes)
    return {i: sel.get(str(i), "chw") for i in range(n)}


def _wino_spec(zoo):
    """tests/test_variants.py::_wino_spec — all 3x3 stride-1, fusable add."""
    b = zoo._Builder("wino_res")
    c0 = b.conv(8, 4, 16, 1, 3)
    c1 = b.conv(8, 8, 14, 1, 3)
    c2 = b.conv(8, 8, 12, 1, 3)
    b.join("add", 8, 10, [c1, c2])
    return b.build()


def _ep_spec(zoo):
    """tests/test_variants.py's eltwise bias + ReLU fold net."""
    b = zoo._Builder("tiny_ep")
    b.conv(8, 4, 12, 1, 3)
    b.eltwise("bias", 8, 10)
    b.eltwise("relu", 8, 10)
    return b.build()


def _case(name):
    """(reference spec, port spec, assignment, batch input shape)."""
    if name == "edge_pbqp":
        return JZ.get("edge_cnn"), TZ.get("edge_cnn"), pbqp_edge_cnn(), (3, 3, 32, 32)
    if name == "edge_mix":
        ts = TZ.get("edge_cnn")
        return JZ.get("edge_cnn"), ts, kernel_mix_assignment(ts), (3, 3, 32, 32)
    if name == "wino_res":
        js, ts = _wino_spec(JZ), _wino_spec(TZ)
        asg = {i: ("winograd-2x2-3x3@wino-128x128"
                   if isinstance(n, JZ.ConvLayer) else "chw")
               for i, n in enumerate(js.nodes)}
        return js, ts, asg, (2, 4, 16, 16)
    js, ts = _ep_spec(JZ), _ep_spec(TZ)
    return js, ts, {0: "im2col-copy-ab-ki@conv-bk64", 1: "chw", 2: "chw"}, (3, 4, 12, 12)


CASES = ["edge_pbqp", "edge_mix", "wino_res", "tiny_ep"]


def test_specs_match_reference():
    for name in JZ.EXECUTABLE_NETS:
        js, ts = JZ.get(name), TZ.get(name)
        assert [type(n).__name__ for n in ts.nodes] == [type(n).__name__ for n in js.nodes]
        assert [tuple(vars(n).values()) for n in ts.nodes] == \
               [tuple(vars(n).values()) for n in js.nodes]
        assert ts.edges == js.edges


def test_kernel_mix_assignment_routes_conv_and_winograd_kernels():
    asg = kernel_mix_assignment(TZ.get("resnet18"))
    cols = list(asg.values())
    assert cols.count("winograd-4x4-3x3@mm-128x128x128") == 1
    assert "winograd-2x2-3x3@wino-128x128" in cols
    assert "conv-1x1-gemm-ab-ki@conv-bk64" in cols
    assert "im2col-copy-ab-ki@conv-bk128" in cols


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("epilogues", [False, True])
def test_lower_matches_reference(name, epilogues):
    js, ts, asg, _ = _case(name)
    jsteps, jlay = JP.lower(js, asg, epilogues=epilogues)
    tsteps, tlay = TP.lower(ts, asg, epilogues=epilogues)
    assert tlay == jlay

    def shape(st):
        out = {"kind": type(st).__name__, "node": st.node,
               "perm": getattr(st, "perm", None), "ins": getattr(st, "ins", None)}
        if hasattr(st, "prim"):
            out.update(prim=st.prim.name, variant=st.variant, stride=st.stride,
                       src=st.src, out=st.out_node,
                       ep=None if st.epilogue is None else
                       (st.epilogue.alias, st.epilogue.bias,
                        st.epilogue.residual, st.epilogue.relu))
        return out
    assert [shape(s) for s in tsteps] == [shape(s) for s in jsteps]
    assert TP.epilogue_signature(tsteps) == JP.epilogue_signature(jsteps)
    assert TP.fused_dlt_count(tsteps) == JP.fused_dlt_count(jsteps)


@pytest.mark.parametrize("name", CASES)
def test_compiled_plan_matches_reference(name, rng):
    """Fused serving plans ("sinks") against the JAX compile_plan."""
    js, ts, asg, shape = _case(name)
    w = JE.make_weights(js)
    x = rng.standard_normal(shape).astype(np.float32)
    jplan = JP.compile_plan(js, asg)
    tplan = TP.compile_plan(ts, asg)
    assert tplan.epilogue_signature == jplan.epilogue_signature
    want = jplan(jnp.asarray(x), w)
    got = tplan(torch.from_numpy(x), TE.make_weights(ts, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **PLAN_TOL)


@pytest.mark.parametrize("name", ["edge_mix", "tiny_ep"])
def test_all_outputs_match_interpreted_reference(name, rng):
    """outputs="all" (unfused, every node) and the port's interpreted path
    against the JAX interpreted executor, node by node."""
    js, ts, asg, shape = _case(name)
    x = rng.standard_normal(shape[1:]).astype(np.float32)
    want = JE.execute(js, asg, JE.make_weights(js), x=jnp.asarray(x),
                      compiled=False).outputs
    tw = TE.make_weights(ts, device="cpu")
    for compiled in (True, False):
        got = TE.execute(ts, asg, tw, x=x, compiled=compiled, device="cpu").outputs
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **PLAN_TOL, err_msg=f"node {k}")


def test_measure_times_every_component():
    ts = TZ.get("edge_cnn")
    rep = TE.execute(ts, TP.heuristic_assignment(ts), measure=True, repeats=2,
                     device="cpu")
    convs = [i for i, n in enumerate(ts.nodes) if isinstance(n, TZ.ConvLayer)]
    assert sorted(rep.primitive_seconds) == convs
    assert all(v > 0 for v in rep.primitive_seconds.values())
    assert rep.total_seconds > 0


def test_weights_from_jax_round_trip(rng):
    """The reference's make_weights through weights_from_jax equals the
    port's own make_weights byte for byte (the seeds agree), and both give
    the same plan outputs."""
    js, ts = JZ.get("edge_cnn"), TZ.get("edge_cnn")
    jw = JE.make_weights(js)
    conv = weights_from_jax({k: np.asarray(v) for k, v in jw.items()}, device="cpu")
    own = TE.make_weights(ts, device="cpu")
    assert sorted(conv) == sorted(own)
    for k in own:
        assert conv[k].dtype == torch.float32
        np.testing.assert_array_equal(conv[k].numpy(), own[k].numpy())
        np.testing.assert_array_equal(own[k].numpy(), np.asarray(jw[k]))
    js_in = JE.source_inputs(js)
    for k, v in TE.source_inputs(ts, device="cpu").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(js_in[k]))
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    plan = TP.compile_plan(ts, pbqp_edge_cnn())
    a, b = plan(x, conv), plan(x, own)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_plan_cache_and_eviction():
    ts = TZ.get("edge_cnn")
    asg = TP.heuristic_assignment(ts)
    p1 = TP.compile_plan(ts, asg, (1, 3, 32, 32))
    assert p1 is TP.compile_plan(ts, asg, (1, 3, 32, 32))
    p2 = TP.compile_plan(ts, asg, (1, 3, 32, 32), epilogues=False)
    assert p2 is not p1 and p2.epilogue_signature == ()
    assert TP.compile_plan(ts, asg, outputs="all", epilogues=True).epilogue_signature == ()
    assert TP.evict_plans(ts, asg) >= 3
    assert TP.evict_plans(ts, asg) == 0
    TE.execute(ts, asg, compiled=False, device="cpu")
    cols = {v for v in asg.values() if v != "chw"}
    assert TE.evict_prim_entries(cols) > 0
    assert TE.evict_prim_entries(cols) == 0


def _mini_res(zoo):
    """A resnet-style block whose declared sizes are not its actual ones,
    as in the zoo's resnets (valid convolutions under declared stage sizes)."""
    b = zoo._Builder("mini_res")
    c0 = b.conv(4, 3, 16, 1, 3)                # actual out 14
    x1 = b.conv(8, 4, 8, 2, 3, prev=c0)        # declared in 8, actual 14 -> 6
    x2 = b.conv(8, 8, 4, 1, 3, prev=x1)        # actual out 4
    sc = b.conv(8, 4, 8, 2, 1, prev=c0)        # declared out 4, actual 7
    b.join("add", 8, 4, [x2, sc])
    return b.build()


def test_residual_fusion_uses_actual_sizes(rng):
    """The one deliberate divergence (Queue C of ROADMAP.md): the reference
    folds the residual onto the shortcut by its declared size, which is
    smaller than the actual one, and its fused plan fails; the port folds it
    onto the conv whose actual size is the join's, and matches the
    reference's unfused plan."""
    js, ts = _mini_res(JZ), _mini_res(TZ)
    asg = JP.heuristic_assignment(js)
    assert TP.spatial_sizes(ts) == {0: 14, 1: 6, 2: 4, 3: 7, 4: 4}
    jw = JE.make_weights(js)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with pytest.raises(TypeError):
        JP.compile_plan(js, asg)(jnp.asarray(x), jw)
    want = JP.compile_plan(js, asg, epilogues=False)(jnp.asarray(x), jw)
    plan = TP.compile_plan(ts, asg)
    assert plan.epilogue_signature == ((2, 4, ("residual",)),)
    got = plan(torch.from_numpy(x), TE.make_weights(ts, device="cpu"))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), **PLAN_TOL)


def test_lower_rejects_incompatible_tile():
    ts = TZ.get("edge_cnn")
    asg = TP.heuristic_assignment(ts)
    asg[0] = asg[0] + "@wino-128x128"
    with pytest.raises(ValueError):
        TP.lower(ts, asg)
