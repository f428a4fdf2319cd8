"""The port's device-time observatory (``dtc_tpu_torch/obs/devprof.py``) on
the CPU:

- a ``torch.profiler`` capture of 2 training steps of the port at tiny
  size, read by ``analyze_capture``: host-op rows in every model component
  and in the phases ``fwd``, ``bwd`` and ``optimizer``, the structural gates
  passing;
- the device logic on a Chrome-trace dict built here in the form a card's
  trace takes (kernel events, their launches by ``correlation``, nested
  ``record_function`` ranges, autograd's backward nodes on their own
  thread with the forward op's ``Sequence number``): each kernel's scope,
  component and phase, NCCL kernels as collectives, the ``External id``
  fallback, the unattributed remainder and its matrix products;
- ``classify_scope`` and ``attribute`` against the JAX package's on the
  same scopes and rows.
"""

import numpy as np
import pytest
import torch

from dtc_tpu.obs import devprof as jdev
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.obs import devprof as dev
from dtc_tpu_torch.train import trainer as trainer_mod


def test_cpu_capture_of_two_port_steps_attributes_every_component(tmp_path):
    """2 steps of the port (2 layers, dropout 0.1) under the trainer's
    device-profile window: rows in every component of a dense GPT, in the
    phases fwd, bwd and optimizer, the backward's matrix products linked to
    their forward sites; every matrix product attributed and the
    unattributed share at most 0.10; the meta's step FLOPs and null memory
    on the CPU."""
    torch.set_num_threads(1)
    model = ts.ModelConfig(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                           max_seq_len=32, dropout=0.1, compute_dtype="float32")
    cfg = ts.TrainConfig(seed=0, parallel="dp", batch=4, steps=3, log_every=1,
                         output_dir=str(tmp_path), dataset="synthetic", warmup_steps=1,
                         obs=ts.ObsConfig(devprof_every=2))
    trainer_mod.train(cfg, model, ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0),
                      device="cpu")
    caps = dev.find_captures(str(tmp_path / "obs" / "devprof"))
    assert len(caps) == 1 and caps[0].endswith("step000002_cadence")
    cap = dev.analyze_capture(caps[0])
    att, meta = cap["attribution"], cap["meta"]
    assert meta["steps"] == 2 and meta["step_flops"] > 0
    assert meta["peak_hbm_bytes"] is None and meta["profiler_device_s"] is None
    want = set(dev.MODEL_COMPONENTS) - {"moe"}
    assert want <= set(att.components), att.components
    assert {"fwd", "bwd", "optimizer"} <= set(att.phases)
    gates = dev.structural_gates(att)
    assert gates["all_dot_fusions_attributed"] and gates["unattributed_share_ok"], gates
    mm_bwd = [dev.classify_scope(r.scope) for r in cap["rows"] if r.name == "MmBackward0"]
    assert mm_bwd and all(c in ("attn_qkv", "attn_proj", "mlp", "head") and p == "bwd"
                          for c, p in mm_bwd)


def test_capture_window_around_caller_code(tmp_path):
    """``CaptureWindow`` brackets code the caller drives: the trace and its
    meta land, ``analyze_capture`` reads the ranges inside; a second
    window opened inside the first warns and captures nothing."""
    with dev.CaptureWindow(str(tmp_path / "w"), steps=1, reason="manual") as w:
        with dev.scope("fwd"), dev.scope("mlp"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with dev.CaptureWindow(str(tmp_path / "inner")) as inner:
            pass
    assert w.ok and w.meta["reason"] == "manual" and not inner.ok
    cap = dev.analyze_capture(str(tmp_path / "w"))
    assert cap["attribution"].components["mlp"] > 0
    assert dev.find_captures(str(tmp_path)) == [str(tmp_path / "w")]


# ---------------------------------------------------------------------------
# the device logic on a card-shaped trace
# ---------------------------------------------------------------------------

MAIN, AUTOGRAD = 100, 200


def _x(cat, name, ts_, dur, tid=MAIN, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def _card_trace():
    """A forward on the main thread, the backward on autograd's, an NCCL
    all-reduce, an optimizer kernel, and three device events no range
    claims."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        _x("Trace", "PyTorch Profiler (0)", 0.0, 10000.0),
        _x("user_annotation", "fwd", 10.0, 400.0),
        _x("user_annotation", "blocks", 20.0, 300.0),
        _x("user_annotation", "attn_qkv", 30.0, 50.0),
        _x("cpu_op", "aten::mm", 35.0, 30.0, **{"Sequence number": 7, "Fwd thread id": 0,
                                              "External id": 1}),
        _x("cuda_runtime", "cuLaunchKernelEx", 40.0, 5.0, correlation=11, **{"External id": 1}),
        _x("user_annotation", "attn_kernel", 100.0, 60.0),
        _x("cpu_op", "_FlashAttention", 105.0, 40.0, **{"Sequence number": 9,
                                                       "Fwd thread id": 0,
                                                       "External id": 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0, correlation=12),
        _x("user_annotation", "mlp", 200.0, 80.0),
        _x("cpu_op", "aten::gelu", 205.0, 20.0, **{"Sequence number": 12, "Fwd thread id": 0,
                                                  "External id": 3}),
        _x("cuda_runtime", "cudaLaunchKernel", 210.0, 5.0, correlation=13),
        # the backward, on autograd's thread: the flash node, and the gelu
        # node whose recompute runs an mlp range inside it
        _x("cpu_op", "autograd::engine::evaluate_function: _FlashAttentionBackward", 600.0,
           100.0, tid=AUTOGRAD, **{"Sequence number": 9, "Fwd thread id": 1}),
        _x("cpu_op", "_FlashAttentionBackward", 601.0, 90.0, tid=AUTOGRAD,
           **{"Sequence number": 9, "Fwd thread id": 1, "External id": 4}),
        _x("cuda_runtime", "cudaLaunchKernel", 610.0, 5.0, tid=AUTOGRAD, correlation=14),
        _x("cuda_runtime", "cudaLaunchKernel", 650.0, 5.0, tid=AUTOGRAD, correlation=15),
        _x("cpu_op", "autograd::engine::evaluate_function: GeluBackward0", 720.0, 60.0,
           tid=AUTOGRAD, **{"Sequence number": 12, "Fwd thread id": 1}),
        _x("user_annotation", "mlp", 725.0, 30.0, tid=AUTOGRAD),
        _x("cuda_runtime", "cudaLaunchKernel", 730.0, 5.0, tid=AUTOGRAD, correlation=16),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 790.0, 60.0,
           tid=AUTOGRAD, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cuda_runtime", "cuLaunchKernelEx", 795.0, 5.0, tid=AUTOGRAD, correlation=17),
        # the gradient all-reduce and the update
        _x("cpu_op", "c10d::allreduce_", 900.0, 30.0, **{"External id": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 905.0, 5.0, correlation=18),
        _x("user_annotation", "optimizer", 950.0, 100.0),
        _x("cpu_op", "aten::_foreach_add_", 955.0, 50.0, **{"External id": 6}),
        _x("cuda_runtime", "cudaLaunchKernel", 960.0, 5.0, correlation=19),
        # unclaimed: a copy, a kernel found by its op's External id only,
        # and a GEMM with neither link
        _x("cpu_op", "aten::copy_", 1100.0, 10.0, **{"External id": 8}),
        _x("cuda_runtime", "cudaMemcpyAsync", 1102.0, 5.0, correlation=20),
    ]
    kernels = [
        (11, "nvjet_tst_128x64_TNT", 300.0, 20.0, None),
        (12, "void (anonymous namespace)::flash_fwd_tc_kernel<64>(CUtensorMap_st)", 330.0,
         40.0, None),
        (13, "void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>", 380.0,
         10.0, None),
        (14, "void (anonymous namespace)::flash_dq_tc_kernel<__nv_bfloat16, 64>", 800.0,
         50.0, None),
        (15, "void (anonymous namespace)::flash_dkv_tc_kernel<__nv_bfloat16, 64>", 850.0,
         60.0, None),
        (16, "void at::native::vectorized_elementwise_kernel<4, GeluBackwardCUDA>", 910.0,
         10.0, None),
        (17, "nvjet_tst_64x32_NNT", 920.0, 25.0, None),
        (18, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         950.0, 70.0, None),
        (19, "void at::native::multi_tensor_apply_kernel<AdamW>", 1030.0, 15.0, None),
        (20, "Memcpy DtoD (Device -> Device)", 1120.0, 5.0, None),
        (None, "void at::native::reduce_kernel<512, 1>", 1130.0, 4.0, 6),
        (None, "nvjet_tst_orphan_TNN", 1140.0, 6.0, None),
    ]
    cats = {"Memcpy DtoD (Device -> Device)": "gpu_memcpy"}
    for corr, name, t0, dur, ext in kernels:
        args = {"device": 0, "stream": 7}
        if corr is not None:
            args["correlation"] = corr
        if ext is not None:
            args["External id"] = ext
        ev.append({"ph": "X", "cat": cats.get(name, "kernel"), "name": name, "ts": t0,
                   "dur": dur, "pid": 0, "tid": 7, "args": args})
    return {"traceEvents": ev}


WANT = {
    "nvjet_tst_128x64_TNT": ("attn_qkv", "fwd", "aten::mm"),
    "flash_fwd_tc_kernel": ("attn_kernel", "fwd", "_FlashAttention"),
    "at::native::vectorized_elementwise_kernel": None,  # two of them: below
    "flash_dq_tc_kernel": ("attn_kernel", "bwd", "_FlashAttentionBackward"),
    "flash_dkv_tc_kernel": ("attn_kernel", "bwd", "_FlashAttentionBackward"),
    "nvjet_tst_64x32_NNT": ("attn_qkv", "bwd", "autograd::engine::evaluate_function: "
                            "MmBackward0"),
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL": ("", "", "c10d::allreduce_"),
    "at::native::multi_tensor_apply_kernel": ("optimizer", "optimizer",
                                              "aten::_foreach_add_"),
    "Memcpy DtoD": ("", "", "aten::copy_"),
    "at::native::reduce_kernel": ("optimizer", "optimizer", "aten::_foreach_add_"),
    "nvjet_tst_orphan_TNN": ("", "", ""),
}


@pytest.mark.parametrize("kernel", sorted(k for k, v in WANT.items() if v))
def test_card_trace_kernel_scopes(kernel):
    """Each kernel of the card-shaped trace takes the scope of its launch:
    forward kernels their enclosing ranges, backward kernels (launched on
    autograd's thread) the forward op's ranges behind the backward marker,
    a kernel without a launch event its op's (``External id``)."""
    rows = dev.device_op_rows(_card_trace())
    assert len(rows) == 12
    r = next(r for r in rows if kernel in r.name)
    comp, phase, op = WANT[kernel]
    assert dev.classify_scope(r.scope) == (comp, phase), r.scope
    assert r.op == op
    if phase == "bwd":
        assert r.scope.startswith(dev.BWD_SCOPE + "/fwd/blocks/")


def test_card_trace_attribution():
    """The recompute's range inside a backward node wins over the linked
    forward scope; the NCCL kernel is a collective; the unclaimed copy is
    data movement; the orphan GEMM is unattributed and named by the gate;
    the totals add up and the busy line is the stream's."""
    rows = dev.device_op_rows(_card_trace())
    elementwise = [dev.classify_scope(r.scope) for r in rows
                   if "vectorized_elementwise_kernel" in r.name]
    assert elementwise == [("mlp", "fwd"), ("mlp", "bwd")]
    att = dev.attribute(rows)
    us = 1e-6
    assert att.total_s == pytest.approx(315 * us)
    assert att.collective_s == pytest.approx(70 * us)
    assert att.components["collectives"] == pytest.approx(70 * us)
    assert att.components["attn_kernel"] == pytest.approx(150 * us)
    assert att.components["data_movement"] == pytest.approx(5 * us)
    assert att.unattributed_s == pytest.approx(6 * us)
    assert att.unattributed_dot_fusions == ["nvjet_tst_orphan_TNN"]
    assert att.phases["bwd"] == pytest.approx(145 * us)
    assert att.busy_s == pytest.approx(att.total_s)
    gates = dev.structural_gates(att)
    assert not gates["all_dot_fusions_attributed"] and gates["unattributed_share_ok"]
    assert len(dev.census_crosscheck(att, {"total": 0.0})) == 1  # 22% in collectives
    assert dev.census_crosscheck(att, {"total": 4e6}) == []
    assert dev.trace_wall_anchor(_card_trace(), 50.0) == (0.0, 50.0)
    spans = dev.device_rows_to_events(rows, anchor=(0.0, 50.0))
    assert spans[0]["t0"] == pytest.approx(50.0 + 300 * us) and spans[0]["cat"] == "device"


# ---------------------------------------------------------------------------
# against the JAX package's attribution
# ---------------------------------------------------------------------------

SCOPES = [
    "", "fwd", "train_step/fwd/blocks/attn_qkv", "fwd/blocks/attn_kernel",
    "transpose(backward)/fwd/blocks/mlp", "transpose(backward)/fwd/embed",
    "optimizer", "fwd/head/ln", "fwd/blocks", "fwd/Block_3/Dropout_0",
    "jit(train_step)/jvp(GPT)/blocks/attn_proj/out_proj",
    "jit(train_step)/transpose(jvp(GPT))/while/body/mlp/fc1", "while/body/cond",
    "fwd/head/lm_head", "prefill/blocks/ln_1", "decode", "router/moe",
]


@pytest.mark.parametrize("scope", SCOPES)
def test_classify_scope_equals_jax(scope):
    assert dev.classify_scope(scope) == jdev.classify_scope(scope)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_equals_jax_on_the_same_rows(seed):
    """Seeded rows (nested ops on two lines, collectives overlapping
    compute) in both packages' row types: the same components, phases,
    totals, overlap and busy line."""
    rng = np.random.RandomState(seed)
    port, ref = [], []
    for i in range(60):
        line = int(rng.randint(2))
        t0 = float(rng.uniform(0, 1e-2))
        dur = float(rng.uniform(1e-6, 1e-3))
        scope = SCOPES[1 + rng.randint(len(SCOPES) - 1)]
        coll = rng.rand() < 0.2
        port.append(dev.OpRow(name="ncclDevKernel_AllReduce" if coll else f"k{i}",
                              op="c10d::allreduce_" if coll else "aten::add", scope=scope,
                              t0_s=t0, dur_s=dur, pid=0, tid=line,
                              kind="collective" if coll else "compute"))
        ref.append(jdev.OpRow(name=f"op{i}", hlo_op="all-reduce.1" if coll else "add.3",
                              hlo_module="", scope=scope, t0_s=t0, dur_s=dur, pid=0, tid=line,
                              kind="collective" if coll else "compute"))
    got, want = dev.attribute(port), jdev.attribute(ref)
    for key in ("components", "phases", "total_s", "compute_s", "collective_s", "overlap_s",
                "unattributed_s", "n_ops", "busy_s"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.component_table(2) == want.component_table(2)
    assert dev.self_times(port) == jdev.self_times(ref)
