"""The trace's reductions and the per-layer readers on a made-up trace."""

import pytest

from perfbench.lib import result, spec, trace, work
from perfbench.tests import tiny


def _trace():
    # Window 0-10 s; device busy 1-3 (a port K1 kernel), 2-4 (an elementwise one), 6-7 (a cuBLAS one).
    ops = [("void topk_stats_stream_kernel<32>(float const*)", 1.0, 3.0),
           ("void at::native::vectorized_elementwise_kernel<4>()", 2.0, 4.0),
           ("nvjet_tss_192x192_64x3_2x1_v_bz_coopB_NNN", 6.0, 7.0),
           ("Memcpy DtoH (Device -> Pinned)", 9.0, 9.5)]
    spans = [("perfbench.to_host", 4.0, 6.0), ("perfbench.cohort0", 0.5, 5.0)]
    matmuls = [("aten::mm", [[16384, 1024], [1024, 16384], []], None, 1.0, 0.6,
                ("nvjet_tss_192x192_64x3_2x1_v_bz_coopB_NNN",))]
    return trace.Trace(ops=ops, spans=spans, matmuls=matmuls, window=(0.0, 10.0),
                       matmul_kernels=frozenset({"nvjet_tss_192x192_64x3_2x1_v_bz_coopB_NNN"}),
                       call_spans=[("perfbench.cohort0", 0.5, 0.7)])


def test_busy_idle_and_gaps():
    t = _trace()
    assert t.busy_intervals() == [(1.0, 4.0), (6.0, 7.0), (9.0, 9.5)]
    assert t.busy_s() == pytest.approx(4.5)
    gaps = dict(t.idle_gaps())
    # 0-1 and 4-5 inside cohort0 (4-6 also inside to_host: the innermost span counts), 7-9 and 9.5-10 outside.
    assert gaps == pytest.approx({"perfbench.cohort0": 1.0, "perfbench.to_host": 2.0, "outside spans": 2.5})
    assert t.top_ops(2)[0][1] == pytest.approx(2.0)


def test_layers_and_readers():
    cell = tiny.cell("train-16x-single")
    t = _trace()
    run = result.Run(cell=cell, trace=t, counts={"profiled_steps": 2, "profiled_logs": 1, "batch": 16384,
                                                 "d_sae": 16384, "d_model": 1024, "k": 32, "k_aux": 512,
                                                 "k_by_span": {"perfbench.cohort0": 32}},
                     model_s={"step_matryoshka": 0.001, "step_select": 0.5, "log_select": 0.0})
    read = {m["name"]: spec.metric_reader(m["name"]) for m in spec.load_benchmark()["per_layer"]}
    assert read["device_idle_pct.train"](run) == pytest.approx(55.0)
    assert read["elementwise_ms_per_step.train"](run) == pytest.approx(1e3 * 2.0 / 2)
    assert read["select_roofline.train"](run) == pytest.approx(100.0 * 2 * 0.5 / 2.0)
    # No port Matryoshka kernel ran: its reader is silent, never 0.
    assert read["matryoshka_roofline.train"](run) is None
    assert read["gemm_roofline.train"](run) == pytest.approx(100.0 * 549755813888 / work.PEAK_OPS["bf16"] / 1.0)
    assert read["host_enqueue_ms_per_step.train"](run) is None


def test_port_kernels_are_found_by_source():
    ports = trace.port_kernels()
    assert ports["topk_stats_stream_kernel"] == "select" and ports["prefix_wgmma_kernel"] == "matryoshka"
    assert trace.kernel_layer("void dgrad_wgmma_kernel<128>(CUtensorMap)", ports) == "matryoshka"
    assert trace.kernel_layer("void at::native::reduce_kernel<512, 1>()", ports) is None
