"""The port on a CUDA card: the decode-attention, flash-attention, decode
megakernel (with its LoRA sites) and FSDP ring kernels against their plain
versions (the ring's at the flagship's and the DP×FSDP×TP sites), and the
kernels on the model's decode and training paths (rematerialisation and
the FSDP ring over virtual ranks included); two gloo ranks sharing the
card for tensor parallelism and the FSDP ring's transport; a resume at the
flagship's widths; a LoRA finetune step and bf16_mixed optimizer steps
against the CPU's; the serving engine's chaos faults on the card's KV cache;
elastic training's snapshots on the card (pinned copies, a restore).
Needs an NVIDIA GPU with ``nvcc``; elsewhere every test skips with the
reason.

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: outputs ``parity.attention_tolerance``
(float32 1e-5, summation order; bfloat16 and int8-dequantized-to-bfloat16
a few bf16 ulps of each head's largest output), gradients
``parity.grad_tolerance`` (float32 1e-5 × the largest |value|; bfloat16 a
few ulps of each head's largest value).
"""

import dataclasses

import pytest
import torch

from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig
from dtc_tpu_torch.ops import decode_attention as da
from dtc_tpu_torch.parity import attention_tolerance

pytestmark = pytest.mark.gpu


def _assert_close(got, want, h):
    limit = attention_tolerance(want, h).to(got.device)
    assert ((got.float() - want.float()).abs() <= limit).all()


@pytest.fixture(scope="session")
def kernels_built():
    """Every kernel library built once, all ``nvcc``s started together
    (through ``load()`` each would build alone when a test first needs it)."""
    if torch.cuda.is_available():
        from dtc_tpu_torch.ops import _build

        _build.build_all()


@pytest.fixture
def cuda(kernels_built):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


def _case(dev, b, s, h, d, qdt, kv, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h * d, device=dev, generator=g).to(qdt)
    k = torch.randn(b, s, h * d, device=dev, generator=g)
    v = torch.randn(b, s, h * d, device=dev, generator=g)
    if kv == "int8":
        k, ks = da.quantize_kv(k, h)
        v, vs = da.quantize_kv(v, h)
        return q, k, v, dict(k_scale=ks, v_scale=vs)
    kvdt = qdt if kv == "same" else {"float32": torch.float32, "bfloat16": torch.bfloat16}[kv]
    return q, k.to(kvdt), v.to(kvdt), {}


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", ["same", "int8", "float32", "bfloat16"])
def test_kernel_matches_plain(cuda, d, qdt, kv):
    b, s, h = 3, 700, 4
    q, k, v, kw = _case(cuda, b, s, h, d, qdt, kv)
    for start in ([0, 350, 5000], 699, 0):
        st = torch.tensor(start, dtype=torch.int32, device=cuda)
        got = da.fused_decode_attention(q, k, v, st, h=h, d=d, **kw)
        want = da.decode_attention_reference(q, k, v, st, h=h, d=d, **kw)
        torch.cuda.synchronize()
        _assert_close(got, want, h)


@pytest.mark.parametrize("d", [32, 48, 112, 128])
@pytest.mark.parametrize("qdt,kv", [(torch.bfloat16, "same"), (torch.float32, "same"),
                                    (torch.bfloat16, "int8"), (torch.bfloat16, "float32")])
def test_kernel_matches_its_split_twin(cuda, d, qdt, kv):
    """The kernel against the eager twin of its own schedule (the same
    splits, p rounded against each split's max, the partials combined in
    split order): rows of one split, of many, ragged, past the cache."""
    b, s, h = 4, 2000, 3
    q, k, v, kw = _case(cuda, b, s, h, d, qdt, kv, seed=d)
    st = torch.tensor([0, 700, 1999, 2500], dtype=torch.int32, device=cuda)
    got = da.fused_decode_attention(q, k, v, st, h=h, d=d, **kw)
    want = da.decode_split_twin(q, k, v, st, h=h, d=d, **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, h)


@pytest.mark.parametrize("d", [32, 48, 128])
@pytest.mark.parametrize("kv", ["same", "int8"])
def test_kernel_is_deterministic_and_rows_are_batch_invariant(cuda, d, kv):
    """Two launches give the same bits (the partials are combined in split
    order, never in arrival order), and each row of a B 4 per-row call
    bit-equals the same row run alone at B 1 with a scalar frontier (split
    boundaries depend on position alone)."""
    b, s, h = 4, 3000, 4
    q, k, v, kw = _case(cuda, b, s, h, d, torch.bfloat16, kv, seed=5)
    starts = [0, 300, 2047, 4000]
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    first = da.fused_decode_attention(q, k, v, st, h=h, d=d, **kw)
    second = da.fused_decode_attention(q, k, v, st, h=h, d=d, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for row, start in enumerate(starts):
        one = {n: t[row:row + 1].contiguous() for n, t in kw.items()}
        alone = da.fused_decode_attention(q[row:row + 1].contiguous(), k[row:row + 1].contiguous(),
                                          v[row:row + 1].contiguous(), start, h=h, d=d, **one)
        torch.cuda.synchronize()
        assert torch.equal(alone, first[row:row + 1]), row


def test_kernel_calls_stand_alone_across_streams(cuda):
    """A call carries no state from another (its partials sit in its own
    scratch, and the combine is a second kernel, not an arrival count): a
    graph captured on one stream and replayed on another while the first
    stream's eager calls still run gives the eager calls' bits, and so do
    they."""
    q, k, v, kw = _case(cuda, 4, 4096, 16, 32, torch.bfloat16, "same", seed=7)
    st = torch.tensor([0, 1000, 2047, 4095], dtype=torch.int32, device=cuda)

    def call():
        return da.fused_decode_attention(q, k, v, st, h=16, d=32, **kw)

    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = call()
    with torch.cuda.stream(side):
        eager = [call() for _ in range(20)]
    graph.replay()  # on the current stream, beside the side stream's calls
    torch.cuda.synchronize()
    assert torch.equal(replayed, want)
    assert all(torch.equal(x, want) for x in eager)


def test_kernel_long_cache_walks_chunks(cuda):
    """A cache of 9000 positions: rows of 16 to 36 splits (256 positions
    each at bf16 D 32), the last one ragged."""
    q, k, v, kw = _case(cuda, 4, 9000, 2, 32, torch.bfloat16, "same", seed=1)
    st = torch.tensor([4095, 4096, 8191, 8999], dtype=torch.int32, device=cuda)
    got = da.fused_decode_attention(q, k, v, st, h=2, d=32)
    want = da.decode_attention_reference(q, k, v, st, h=2, d=32)
    _assert_close(got, want, 2)


def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    q, k, v, _ = _case(cuda, 2, 64, 2, 32, torch.bfloat16, "same")
    before = da.launches
    da.fused_decode_attention(q, k, v, 5, h=2, d=32)
    assert da.launches == before + 1
    with pytest.raises(ValueError):  # a head_dim the kernel has no instance for
        da.fused_decode_attention(q, k, v, 5, h=8, d=8)
    with pytest.raises(ValueError):  # a non-contiguous cache
        da.fused_decode_attention(q, k[:, ::2], v[:, ::2], 5, h=2, d=32)


@pytest.mark.parametrize("max_seq_len", [64, 4100])
def test_generate_on_cuda_matches_cpu_fp32(cuda, max_seq_len):
    """The model's decode path through the kernel gives the CPU path's
    greedy tokens (float32, TF32 off), at any cache length: 4100 is one the
    TPU kernels' 512-block rule would have refused."""
    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.models.gpt import GPT

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=2, d_ff=128,
                      max_seq_len=max_seq_len, compute_dtype="float32")
    cpu = GPT(cfg, device="cpu", seed=3)
    gpu = GPT(cfg, device=cuda, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    prompt = [[5, 9, 1, 44, 2, 7]]
    before = da.launches
    out_gpu = generate(gpu, prompt, 12)
    assert da.launches - before == cfg.n_layers * 11
    assert out_gpu.cpu().tolist() == generate(cpu, prompt, 12).tolist()


# --- flash attention (training) ------------------------------------------


def _flash_case(dev, b, t, h, d, dt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, t, h * d, device=dev, generator=g).to(dt) for _ in range(4)]


def _flash_matches_plain(dev, b, t, h, d, dt, seed=0):
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import grad_tolerance

    q, k, v, do = _flash_case(dev, b, t, h, d, dt, seed)
    out, lse = fa.flash_attention_forward(q, k, v, h)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, h)
    torch.cuda.synchronize()
    _assert_close(out, want_out, h)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    got = fa.flash_attention_backward(q, k, v, want_out, want_lse, do, h)
    want = fa.flash_attention_backward_reference(q, k, v, want_out, want_lse, do, h)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.dtype == dt
        assert ((g_.float() - w_.float()).abs() <= grad_tolerance(w_, h).to(dev)).all()


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2, 64, 100, 512])
def test_flash_kernels_match_plain(cuda, t, dt, d):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against their
    plain versions, at tile-aligned and ragged T, at every head dim the
    kernels have."""
    _flash_matches_plain(cuda, 2, t, 2, d, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", [(2, 1000, 3, 32), (1, 1024, 8, 48), (1, 300, 5, 112)])
def test_flash_kernels_match_plain_where_jax_transposes(cuda, b, t, h, d, dt):
    """Shapes that take the JAX package's transpose-layout family (TPU kernel
    rows 10-14): head counts no 128-lane group divides, head dims that do
    not divide 128."""
    _flash_matches_plain(cuda, b, t, h, d, dt, seed=h + d)


def test_flash_kernels_match_plain_at_t8192(cuda):
    """T 8192, where the JAX package takes its split backward (TPU kernel
    rows 8-9), bfloat16."""
    _flash_matches_plain(cuda, 1, 8192, 2, 32, torch.bfloat16, seed=8)


def test_flash_autograd_counts_launches_and_is_deterministic(cuda):
    from dtc_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda, 2, 300, 4, 32, torch.bfloat16, seed=2)
    grads = []
    for _ in range(2):
        f0, b0 = fa.fwd_launches, fa.bwd_launches
        xs = [x.clone().view(2, 300, 4, 32).requires_grad_(True) for x in (q, k, v)]
        fa.flash_causal_attention(*xs).backward(do.view(2, 300, 4, 32))
        assert (fa.fwd_launches - f0, fa.bwd_launches - b0) == (1, fa.BWD_KERNELS)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    x = torch.zeros(2, 300, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP"):  # a head_dim past the kernels'
        fa.flash_attention_forward(x, x, x, 1)


def test_training_on_cuda_runs_the_flash_kernels_and_matches_dense(cuda):
    """``attention: auto`` on the card trains through the flash kernels
    (one forward and two backward launches per layer per step, warmup
    included); float32 losses equal dense attention's within 1e-4 (TF32
    off)."""
    import dataclasses

    from dtc_tpu_torch.config.schema import ObsConfig, OptimConfig, TrainConfig
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(seed=0, parallel="dp", batch=2, steps=3, log_every=3, output_dir="",
                       dataset="synthetic", warmup_steps=1, prefetch=2,
                       obs=ObsConfig(enabled=False))
    ocfg = OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    mcfg = ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=2, d_ff=128,
                       max_seq_len=96, compute_dtype="float32")
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    auto = train(tcfg, mcfg, ocfg).losses
    assert fa.fwd_launches - f0 == 2 * 4 and fa.bwd_launches - b0 == 2 * 4 * fa.BWD_KERNELS
    dense = train(tcfg, dataclasses.replace(mcfg, attention="dense"), ocfg).losses
    assert max(abs(a - b) for a, b in zip(auto, dense)) <= 1e-4


# --- the tensor-core flash kernels (bf16 forward, dq and dk/dv) -----------


def _routes():
    from dtc_tpu_torch.ops import flash_attention as fa

    return dict(fa.fwd_route_launches), dict(fa.dkv_route_launches)


def _dq_routes():
    from dtc_tpu_torch.ops import flash_attention as fa

    return dict(fa.dq_route_launches)


def _ratio(got, want, limit):
    return ((got.float() - want.float()).abs() / limit.to(got.device)).max().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_tc_kernels_match_plain_at_a_ragged_t(cuda, d, causal):
    """The bf16 forward, dq and dk/dv kernels (route "tc": wgmma on
    TMA-staged tiles) against their plain versions at T 1000, every head dim
    (each swizzle and box count of ``flash_plan``), causal and not; the
    backward with bf16 and with float32 gradients (the ring's blocks).
    Every launch on the "tc" route; a second launch gives the same bits."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import grad_tolerance

    h = 3
    q, k, v, do = _flash_case(cuda, 2, 1000, h, d, torch.bfloat16, seed=d + causal)
    (f0, k0), q0, runs = _routes(), _dq_routes(), []
    for _ in range(2):
        out, lse = fa._forward_kernel(q, k, v, h, causal)
        grads = [fa._backward_kernels(q, k, v, out, lse, do, h, causal, gd)
                 for gd in (torch.bfloat16, torch.float32)]
        runs.append((out, lse, grads))
    (f1, k1), q1 = _routes(), _dq_routes()
    assert (f1["tc"] - f0["tc"], q1["tc"] - q0["tc"], k1["tc"] - k0["tc"]) == (2, 4, 4)
    assert (f1["fma"], q1["fma"], k1["fma"]) == (f0["fma"], q0["fma"], k0["fma"])
    (out, lse, grads), (out2, lse2, grads2) = runs
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for g1, g2 in zip(grads, grads2) for a, b in zip(g1, g2))
    want_out, want_lse = fa.flash_attention_reference(q, k, v, h, causal)
    _assert_close(out, want_out, h)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    for gd, got in zip((torch.bfloat16, torch.float32), grads):
        want = fa.flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, gd)
        for g_, w_ in zip(got, want):
            assert g_.dtype == gd
            assert _ratio(g_, w_, grad_tolerance(w_.to(torch.bfloat16), h)) <= 1.0


def test_float32_flash_launches_take_the_cuda_cores(cuda):
    """float32 keeps the CUDA-core kernels (route "fma"): TF32 would break
    its 1e-5 limit."""
    from dtc_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(cuda, 1, 100, 2, 32, torch.float32)
    (f0, k0), q0 = _routes(), _dq_routes()
    out, lse = fa.flash_attention_forward(q, k, v, 2)
    fa.flash_attention_backward(q, k, v, out, lse, do, 2)
    (f1, k1), q1 = _routes(), _dq_routes()
    assert (f1["fma"] - f0["fma"], q1["fma"] - q0["fma"], k1["fma"] - k0["fma"]) == (1, 1, 1)
    assert (f1["tc"], q1["tc"], k1["tc"]) == (f0["tc"], q0["tc"], k0["tc"])


def _dq_limit(want, h):
    """4 bf16 ulps of each head's largest dq (``grad_tolerance`` of the
    bf16-rounded gradient, for float32 gradients too)."""
    from dtc_tpu_torch.parity import grad_tolerance

    return grad_tolerance(want.to(torch.bfloat16), h)


def _dq_check(dev, b, t, h, d, causal, gd, seed):
    """The tensor-core dq kernel against the plain dq and its tiling twin,
    delta against the plain rowsum(dO ⊙ O) within float32's 1e-5 of its
    largest value, and two launches bit-equal, all on the "tc" route."""
    from dtc_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(dev, b, t, h, d, torch.bfloat16, seed=seed)
    out, lse = fa.flash_attention_reference(q, k, v, h, causal)
    q0 = _dq_routes()
    (dq, delta), (dq2, delta2) = (fa._dq_kernel(q, k, v, out, lse, do, h, causal, gd)
                                  for _ in range(2))
    q1 = _dq_routes()
    assert (q1["tc"] - q0["tc"], q1["fma"] - q0["fma"]) == (2, 0)
    assert dq.dtype == gd and torch.equal(dq, dq2) and torch.equal(delta, delta2)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, gd)[0]
    assert _ratio(dq, want, _dq_limit(want, h)) <= 1.0
    twin, twin_delta = fa.flash_dq_twin(q, k, v, out, lse, do, h, causal, grad_dtype=gd)
    assert _ratio(dq, twin, _dq_limit(twin, h)) <= 1.0
    assert (delta - twin_delta).abs().max().item() <= 1e-5 * twin_delta.abs().max().item()


@pytest.mark.parametrize("gd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_tc_dq_kernel_matches_plain_at_a_ragged_t(cuda, d, causal, gd):
    """The bf16 dq kernel (``flash_dq_tc_kernel``) at T 1000 (the last key
    tile ragged: masked past T without the causal mask), every head dim
    (the MN-major K operand in one, three, five or seven boxes), causal
    and not, bf16 and float32 (the ring's blocks) gradients."""
    _dq_check(cuda, 2, 1000, 3, d, causal, gd, seed=d + 2 * causal)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_dq_kernel_matches_plain_at_t8192(cuda, causal):
    """T 8192 (128 key tiles: the K/V stage ring wraps 32 times), float32
    gradients, causal and not."""
    _dq_check(cuda, 1, 8192, 2, 32, causal, torch.float32, seed=81)


def test_tc_dq_planted_faults_land_over_the_limit(cuda):
    """chip_smoke's crafted dq faults (dS not rounded to bf16 on a
    cancelling row; q's scale unrounded; keys past a ragged T unmasked
    without the causal mask, shown where p overflows) land over the limit
    while the kernel stays within it; and delta read from the next row
    lands over it on random inputs."""
    import chip_smoke

    from dtc_tpu_torch.ops import flash_attention as fa

    for name, (kern, fault) in chip_smoke.dq_fault_cases().items():
        assert kern <= 1.0 < fault, name
    h = 3
    q, k, v, do = _flash_case(cuda, 2, 1000, h, 32, torch.bfloat16, seed=7)
    out, lse = fa.flash_attention_reference(q, k, v, h)
    dq, _ = fa._dq_kernel(q, k, v, out, lse, do, h, True, torch.bfloat16)
    want = chip_smoke.dq_plain(q, k, v, out, lse, do, h, True)
    shifted = chip_smoke.dq_plain(q, k, v, out, lse, do, h, True, delta_shift=1)
    limit = _dq_limit(want, h)
    assert _ratio(dq, want, limit) <= 1.0 < _ratio(shifted, want, limit)


def test_tc_kernels_launch_from_a_thread_without_cuda_work(cuda):
    """The tensor-core launchers encode TMA maps with cuTensorMapEncodeTiled,
    which needs the device's context current on the calling thread: each
    kernel launches as the first CUDA work of a fresh thread (as the dq
    kernel does on autograd's backward thread) and gives the main thread's
    bits."""
    import threading

    from dtc_tpu_torch.ops import flash_attention as fa

    h = 2
    q, k, v, do = _flash_case(cuda, 1, 200, h, 32, torch.bfloat16, seed=4)
    out, lse = fa._forward_kernel(q, k, v, h, True)
    _, delta = fa._dq_kernel(q, k, v, out, lse, do, h, True, torch.bfloat16)
    calls = {
        "fwd": lambda: fa._forward_kernel(q, k, v, h, True),
        "dq": lambda: fa._dq_kernel(q, k, v, out, lse, do, h, True, torch.bfloat16),
        "dkv": lambda: fa._dkv_kernel(q, k, v, lse, delta, do, h, True, torch.bfloat16),
    }
    for name, call in calls.items():
        got = {}
        th = threading.Thread(target=lambda: got.update(res=call()))
        th.start()
        th.join()
        torch.cuda.synchronize()
        assert "res" in got, f"{name}: the launch raised on a fresh thread"
        assert all(torch.equal(a, b) for a, b in zip(got["res"], call())), name


def test_tc_dq_kernel_rejects_a_misaligned_tensor(cuda):
    """TMA needs 16-byte-aligned bases: a bf16 dq launch on a tensor 2 bytes
    off raises before any launch, and nothing falls back."""
    from dtc_tpu_torch.ops import flash_attention as fa

    h, t, d = 2, 64, 32
    q, k, v, do = _flash_case(cuda, 1, t, h, d, torch.bfloat16)
    out, lse = fa.flash_attention_reference(q, k, v, h)
    off = torch.empty(t * h * d + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, t, h * d)
    off.copy_(out)
    q0 = _dq_routes()
    with pytest.raises(ValueError, match="aligned"):
        fa._dq_kernel(q, k, v, off, lse, do, h, True, torch.bfloat16)
    assert _dq_routes() == q0


@pytest.mark.parametrize("d", [32, 128])
def test_tc_forward_matches_its_tiling_twin(cuda, d):
    """The kernel against ``flash_forward_twin`` at its own key tile (64):
    the same one-pass softmax and rounding points, so the two differ only
    where float32 sums in another order flip a rounding of p or of out
    (limit ``attention_tolerance``)."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import attention_tolerance

    h = 2
    q, k, v, _ = _flash_case(cuda, 2, 1000, h, d, torch.bfloat16, seed=d)
    out, lse = fa.flash_attention_forward(q, k, v, h)
    twin, twin_lse = fa.flash_forward_twin(q, k, v, h, True, fa.TILE)
    assert _ratio(out, twin, attention_tolerance(twin, h)) <= 1.0
    assert (lse - twin_lse).abs().max().item() <= 1e-5


def _faulty_forward(q, k, v, h, shift=0, round_p=True, round_scale=True):
    """The plain forward with a planted fault: the causal mask ``shift``
    columns off; p not rounded to v's dtype before P·V; q scaled by the
    float32 ``D**-0.5`` without rounding (scale or product) to q's dtype."""
    from dtc_tpu_torch.ops import flash_attention as fa

    b, t, hd = q.shape
    d = hd // h
    q4, k4, v4 = (x.reshape(b, t, h, d) for x in (q, k, v))
    qs = (q4 * fa._scale_q(d, q.dtype)).float() if round_scale else q4.float() * d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k4.float())
    ar = torch.arange(t, device=q.device)
    s = torch.where(ar[None, :] <= ar[:, None] + shift, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float() if round_p else p, v4.float())
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).reshape(b, t, hd)
    return out, (m + torch.log(l)).squeeze(-1)


def test_tc_planted_faults_land_over_the_limit(cuda):
    """The limits that hold the tensor-core kernels catch: a causal mask one
    column off (out); the q scale applied unrounded (lse, float32 1e-5: on
    random inputs it moves out by under the 4-ulp limit); delta dropped from
    the backward (dk); p not rounded to bf16 before P·V (out). The last moves
    each term by at most half a bf16 ulp of p, under the 4-ulp limit of a
    row's largest output on random inputs (measured 0.25 of it); it shows
    where a row's terms cancel: row 1 of the crafted case sees key 0 with
    p 1 and key 1 with p exp(-0.70703125), which rounds to 0.4921875, and
    v 31.5 and -64, so the rounded sum is exactly 0. The kernel stays within
    every limit on the same inputs."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import attention_tolerance, grad_tolerance

    h = 3
    q, k, v, do = _flash_case(cuda, 2, 1000, h, 32, torch.bfloat16, seed=5)
    out, lse = fa.flash_attention_forward(q, k, v, h)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, h)
    limit = attention_tolerance(want_out, h)
    assert _ratio(out, want_out, limit) <= 1.0 and (lse - want_lse).abs().max() <= 1e-5
    shifted, _ = _faulty_forward(q, k, v, h, shift=1)
    assert _ratio(shifted, want_out, limit) > 1.0
    _, unrounded_lse = _faulty_forward(q, k, v, h, round_scale=False)
    assert (unrounded_lse - want_lse).abs().max().item() > 1e-5
    grads = fa.flash_attention_backward(q, k, v, want_out, want_lse, do, h)
    want = fa.flash_attention_backward_reference(q, k, v, want_out, want_lse, do, h)
    no_delta = fa.flash_attention_backward_reference(q, k, v, torch.zeros_like(out), want_lse,
                                                     do, h)
    dk_limit = grad_tolerance(want[1], h)
    assert _ratio(grads[1], want[1], dk_limit) <= 1.0
    assert _ratio(no_delta[1], want[1], dk_limit) > 1.0

    q, k, v = (torch.zeros(1, 2, 32, device=cuda) for _ in range(3))
    q[0, :, 0], k[0, 1, 0], v[0, 0], v[0, 1] = 1.0, -4.0, 31.5, -64.0
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, _ = fa.flash_attention_forward(q, k, v, 1)
    want_out, _ = fa.flash_attention_reference(q, k, v, 1)
    assert float(want_out[0, 1].abs().max()) == 0.0
    limit = attention_tolerance(want_out, 1)
    assert _ratio(out, want_out, limit) <= 1.0
    assert _ratio(_faulty_forward(q, k, v, 1, round_p=False)[0], want_out, limit) > 1.0


@pytest.mark.parametrize("mode", ["block", "block_save_flash", "mlp"])
def test_remat_on_cuda_gives_the_bits_of_none(cuda, mode):
    """One bf16 training step with dropout 0.1 through the flash kernels:
    each remat mode gives ``none``'s loss and gradients bit for bit and
    leaves the generator in the same state; ``block`` re-runs the flash
    forward in the backward, the other modes do not."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import flash_attention as fa

    cfg = ModelConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=4, d_ff=512,
                      max_seq_len=256, dropout=0.1, compute_dtype="bfloat16")
    x = torch.randint(0, 97, (2, 256), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    runs = {}
    for m in ("none", mode):
        model = GPT(dataclasses.replace(cfg, remat=m), device=cuda, seed=0)
        gen = torch.Generator(cuda).manual_seed(3)
        f0 = fa.fwd_launches
        loss = model(x, train=True, targets=x.roll(-1, 1), generator=gen)
        loss.backward()
        torch.cuda.synchronize()
        runs[m] = (loss, [p.grad for p in model.parameters()], gen.get_state(),
                   fa.fwd_launches - f0)
    (l0, g0, s0, n0), (l1, g1, s1, n1) = runs["none"], runs[mode]
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1) == (2, 4 if mode == "block" else 2)


# --- the layer-fused decode megakernel (serving, fused_layers) ------------

_MK_MODELS = {}


def _mk_model(dev, d, compute, kv, n_layers=2, s=64):
    """A small fused_layers GPT on the card (4 heads of ``d``) whose biases
    and LayerNorm parameters are random too, so every rounding point of
    ``dense`` and LayerNorm is exercised."""
    from dtc_tpu_torch.models.gpt import GPT

    key = (d, compute, kv, n_layers, s)
    if key not in _MK_MODELS:
        cfg = ModelConfig(vocab_size=97, d_model=4 * d, n_layers=n_layers, n_heads=4,
                          d_ff=8 * d, max_seq_len=s, compute_dtype=compute,
                          kv_cache_dtype=kv, decode_attention="fused_layers")
        model = GPT(cfg, device=dev, seed=d)
        g = torch.Generator(device=dev).manual_seed(d + 1)
        with torch.no_grad():
            for p in model.parameters():
                if p.ndim == 1:
                    p.add_(0.2 * torch.randn(p.shape, device=dev, generator=g))
        _MK_MODELS[key] = model
    return _MK_MODELS[key]


def _mk_inputs(model, b, t, seed):
    """Residual input (B, t, d_model) in the compute dtype and a cache of
    random contents (int8 payloads with positive scales)."""
    from dtc_tpu_torch.generate import init_cache
    from dtc_tpu_torch.models.gpt import DTYPES

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = init_cache(model, b)
    for name, buf in cache.items():
        if name == "index":
            continue
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-127, 128, buf.shape, device=dev, generator=g))
        elif name.endswith("scale"):
            buf.copy_(0.005 + 0.015 * torch.rand(buf.shape, device=dev, generator=g))
        else:
            buf.copy_(0.5 * torch.randn(buf.shape, device=dev, generator=g))
    x = torch.randn(b, t, model.cfg.d_model, device=dev, generator=g)
    return x.to(DTYPES[model.cfg.compute_dtype]), cache


def _mk_run(model, x, cache, idx, kernel):
    from dtc_tpu_torch.ops import decode_fused

    c = {k: v.clone() for k, v in cache.items()}
    fn = decode_fused.fused_layers if kernel else decode_fused.fused_layers_reference
    out = fn(x, model.stage.blocks, c, idx)
    torch.cuda.synchronize()
    return out, c


def _mk_limit(want, compute, ulps=8):
    """float32: 1e-5 of the largest |value| (at least 1e-5); bfloat16:
    ``ulps`` ulps of each row's largest |value| (a flipped rounding in the
    kernel's and cuBLAS's different sum orders moves a value by one ulp,
    and the flips spread through the following products)."""
    w = want.float()
    if compute == "float32":
        return 1e-5 * max(float(w.abs().max()), 1.0)
    _, e = torch.frexp(w.abs().amax(dim=-1, keepdim=True))
    return ulps * torch.exp2((e - 8).float())


def _mk_assert_close(got, want, compute, what):
    diff = (got.float() - want.float()).abs()
    assert (diff <= _mk_limit(want, compute)).all(), f"{what}: {float(diff.max())}"


def _mk_check_cache(c_got, c_want, compute, h):
    """Every cache entry, per (position, head). An int8 cache is compared
    dequantized, under the bfloat16 limit: a k or v that differs by a
    flipped rounding moves its payload by a step (and its scale with the
    head's largest value), an error of the size of a few bf16 ulps."""
    for name in ("k", "v"):
        got, want = c_got[name], c_want[name]
        hd = got.shape[-1]
        if got.dtype == torch.int8:
            sc = f"{name}_scale"
            got = got.float() * c_got[sc].repeat_interleave(hd // h, dim=-1)
            want = want.float() * c_want[sc].repeat_interleave(hd // h, dim=-1)
            _mk_assert_close(got.view(-1, h, hd // h), want.view(-1, h, hd // h), "bfloat16", name)
        else:
            _mk_assert_close(got.view(-1, h, hd // h), want.view(-1, h, hd // h), compute, name)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_megakernel_matches_plain(cuda, d, t, b, kv):
    """The megakernel against its plain version at scalar and per-row
    frontiers from 0 to S - t and past S: the returned residual and every
    cache entry. float32 compute over a float32 cache, bfloat16 compute
    over bfloat16 and int8 caches."""
    from dtc_tpu_torch.ops import decode_fused

    compute = "float32" if kv == "float32" else "bfloat16"
    model = _mk_model(cuda, d, compute, "auto" if kv != "int8" else "int8")
    s = model.cfg.max_seq_len
    x, cache = _mk_inputs(model, b, t, seed=d * 100 + t * 10 + b)
    starts = [0, s - t, s + 5, 17][:b] if b > 1 else [s - t]
    for idx in (torch.tensor(starts, dtype=torch.int32, device=cuda),
                torch.tensor(0, dtype=torch.int32, device=cuda),
                torch.tensor(s - t, dtype=torch.int32, device=cuda),
                torch.tensor(s + 3, dtype=torch.int32, device=cuda)):
        before = decode_fused.launches
        got, c_got = _mk_run(model, x, cache, idx, kernel=True)
        assert decode_fused.launches == before + 1
        want, c_want = _mk_run(model, x, cache, idx, kernel=False)
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.isfinite(got.float()).all()
        _mk_assert_close(got, want, compute, f"out at {idx.tolist()}")
        _mk_check_cache(c_got, c_want, compute, 4)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_megakernel_float32_compute_over_narrow_caches(cuda, kv):
    model = _mk_model(cuda, 32, "float32", kv)
    x, cache = _mk_inputs(model, 4, 4, seed=9)
    idx = torch.tensor([0, 7, 60, 33], dtype=torch.int32, device=cuda)
    got, c_got = _mk_run(model, x, cache, idx, kernel=True)
    want, c_want = _mk_run(model, x, cache, idx, kernel=False)
    # A k or v whose float32 value lies within the sums' error of a
    # rounding boundary of the narrow cache dtype rounds the other way: a
    # bf16 ulp or an int8 step in the cache, about 1e-3 of a score.
    diff = (got - want).abs().max().item()
    assert diff <= 1e-3 * max(want.abs().max().item(), 1.0), diff
    _mk_check_cache(c_got, c_want, "bfloat16", 4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_megakernel_is_deterministic_and_rows_are_independent(cuda, compute):
    """Two runs give the same bits; row j of a t = 4 window equals a t = 1
    step at frontier + j bit for bit, caches included (greedy speculation's
    token identity rests on it); a row's output does not change with B."""
    from dtc_tpu_torch.ops import decode_fused

    model = _mk_model(cuda, 32, compute, "auto", n_layers=3)
    x, cache = _mk_inputs(model, 4, 4, seed=5)
    idx = torch.tensor([3, 20, 0, 41], dtype=torch.int32, device=cuda)
    out1, c1 = _mk_run(model, x, cache, idx, kernel=True)
    out2, c2 = _mk_run(model, x, cache, idx, kernel=True)
    assert torch.equal(out1, out2)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
    # Window row j is a single-token step at frontier idx + j: run the four
    # steps in order on one cache and compare outputs and caches bit for bit.
    seq = {k: v.clone() for k, v in cache.items()}
    for j in range(4):
        one = decode_fused.fused_layers(x[:, j:j + 1].contiguous(), model.stage.blocks, seq,
                                        idx + j)
        assert torch.equal(one[:, 0], out1[:, j]), j
    torch.cuda.synchronize()
    assert all(torch.equal(seq[k], c1[k]) for k in c1 if k != "index")
    for r in range(4):
        row_cache = {k: v[:, r:r + 1].contiguous() if k != "index" else v
                     for k, v in cache.items()}
        alone, _ = _mk_run(model, x[r:r + 1].contiguous(), row_cache, idx[r:r + 1], kernel=True)
        assert torch.equal(alone[0], out1[r])


def test_fused_layers_decode_launches_the_megakernel_once_per_step(cuda):
    """Under ``fused_layers`` on the card, each decode step launches the
    megakernel once for the whole layer stack and the per-layer decode
    kernel never; greedy tokens equal the CPU's (float32, TF32 off), and
    spec_generate emits them too."""
    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_fused
    from dtc_tpu_torch.spec import extract_draft, spec_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=97, d_model=64, n_layers=4, n_heads=2, d_ff=128,
                      max_seq_len=64, compute_dtype="float32", decode_attention="fused_layers")
    cpu = GPT(cfg, device="cpu", seed=3)
    gpu = GPT(cfg, device=cuda, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    prompt = [[5, 9, 1, 44, 2, 7]]
    m0, d0 = decode_fused.launches, da.launches
    out = generate(gpu, prompt, 12)
    assert decode_fused.launches - m0 == 11 and da.launches == d0
    assert out.cpu().tolist() == generate(cpu, prompt, 12).tolist()
    spec = spec_generate(gpu, extract_draft(gpu, 2), prompt, 12, spec_k=4)
    assert spec.cpu().tolist() == out.cpu().tolist()


def test_megakernel_rejects_bad_input(cuda):
    from dtc_tpu_torch.ops import decode_fused

    model = _mk_model(cuda, 32, "bfloat16", "auto")
    x, cache = _mk_inputs(model, 2, 1, seed=1)
    idx = torch.tensor(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not the compute dtype
        decode_fused.fused_layers(x.float(), model.stage.blocks, cache, idx)
    with pytest.raises(ValueError):  # a window wider than SPEC_MAX_K
        decode_fused.fused_layers(x.repeat(1, 9, 1), model.stage.blocks, cache, idx)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [48, 80, 96, 112])
def test_megakernel_matches_plain_at_the_new_head_dims(cuda, d, compute, kv):
    """Head dims 48, 80, 96 and 112 (a head row of 3, 5, 6, 7, 10, 12, 14,
    20, 24 or 28 16-byte chunks leaves a position group's last lanes idle):
    one launch, the residual and every cache entry against the plain
    version, t 1 and a t 4 window, per-row frontiers from 0 to past S."""
    from dtc_tpu_torch.ops import decode_fused

    model = _mk_model(cuda, d, compute, kv)
    s = model.cfg.max_seq_len
    for t in (1, 4):
        x, cache = _mk_inputs(model, 4, t, seed=d + t)
        idx = torch.tensor([0, s - t, s + 5, 17], dtype=torch.int32, device=cuda)
        before = decode_fused.launches
        got, c_got = _mk_run(model, x, cache, idx, kernel=True)
        assert decode_fused.launches == before + 1
        want, c_want = _mk_run(model, x, cache, idx, kernel=False)
        assert torch.isfinite(got.float()).all()
        if compute == "float32" and kv != "float32":
            # As test_megakernel_float32_compute_over_narrow_caches: a k or v
            # within the sums' error of a rounding boundary of the narrow
            # cache dtype rounds the other way.
            diff = (got - want).abs().max().item()
            assert diff <= 1e-3 * max(want.abs().max().item(), 1.0), diff
            _mk_check_cache(c_got, c_want, "bfloat16", 4)
        else:
            _mk_assert_close(got, want, compute, f"out at t {t}")
            _mk_check_cache(c_got, c_want, compute, 4)


def test_megakernel_raises_at_a_head_dim_without_an_instance(cuda):
    """Head dim 8 (no flash or decode kernel has it either): ValueError
    before any launch."""
    from dtc_tpu_torch.ops import decode_fused

    model = _mk_model(cuda, 8, "bfloat16", "auto")
    x, cache = _mk_inputs(model, 2, 1, seed=2)
    before = decode_fused.launches
    with pytest.raises(ValueError, match="head_dim 8"):
        decode_fused.fused_layers(x, model.stage.blocks, cache,
                                  torch.tensor(3, dtype=torch.int32, device=cuda))
    assert decode_fused.launches == before


@pytest.mark.parametrize("b,t", [(4, 8), (8, 8)])
def test_megakernel_at_the_1b_ladders_d_ff(cuda, b, t):
    """d_ff 8192 (the 1b ladder's: fc2 reads 16 K chunks, fc1's columns
    fill several tiles a block) at R = B * t = 32 rows (one row block:
    every weight byte read once) and 64 (two row blocks): the residual
    and the caches against the plain version."""
    import dataclasses

    from dtc_tpu_torch.models.gpt import GPT

    base = _mk_model(cuda, 64, "bfloat16", "auto")
    model = GPT(dataclasses.replace(base.cfg, d_model=128, n_heads=2, d_ff=8192), device=cuda,
                seed=12)
    g = torch.Generator(device=cuda).manual_seed(13)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.2 * torch.randn(p.shape, device=cuda, generator=g))
    s = model.cfg.max_seq_len
    x, cache = _mk_inputs(model, b, t, seed=14)
    idx = torch.tensor(([0, s - t, s + 5, 17] * 2)[:b], dtype=torch.int32, device=cuda)
    got, c_got = _mk_run(model, x, cache, idx, kernel=True)
    want, c_want = _mk_run(model, x, cache, idx, kernel=False)
    _mk_assert_close(got, want, "bfloat16", "out")
    _mk_check_cache(c_got, c_want, "bfloat16", 2)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_megakernel_graph_replay_equals_eager(cuda, kv):
    """The kernel captured in a CUDA graph (its counter memset a node of
    it) and replayed, also on another stream, gives the eager launch's bits,
    residual and caches, at frontiers of one and of several splits."""
    from dtc_tpu_torch.ops import decode_fused

    model = _mk_model(cuda, 32, "bfloat16", kv, s=1024)
    blocks = model.stage.blocks
    x, cache = _mk_inputs(model, 4, 4, seed=21)
    idx = torch.tensor([3, 300, 700, 1020], dtype=torch.int32, device=cuda)
    eager, c_eager = _mk_run(model, x, cache, idx, kernel=True)
    c_graph = {k: v.clone() for k, v in cache.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_fused.fused_layers(x, blocks, {k: v.clone() for k, v in cache.items()}, idx)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = decode_fused.fused_layers(x, blocks, c_graph, idx)
    for stream in (torch.cuda.current_stream(), torch.cuda.Stream()):
        for k, v in cache.items():
            c_graph[k].copy_(v)
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert all(torch.equal(c_graph[k], c_eager[k]) for k in c_eager)


# --- the megakernel's LoRA sites (adapter serving) -------------------------

def _lora_stack(model, n_slots, seed, scale=0.3):
    """A resident factor stack: slot 0 zero (base), the others random."""
    from dtc_tpu_torch.adapters import init_lora_stack

    stack = init_lora_stack(model, n_slots)
    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for k, v in stack.items():
            fan = v.shape[-1]
            v[1:].copy_(scale * torch.randn(v[1:].shape, device=v.device, generator=g) / fan ** 0.5)
    return stack


def _flagship_lora_model(dev, compute, alpha):
    """The flagship's widths and depth with an adapter of rank 8 on all six
    sites, random biases and LayerNorm parameters."""
    import dataclasses
    from pathlib import Path

    from dtc_tpu_torch.config.loader import load_finetune_config
    from dtc_tpu_torch.models.gpt import GPT

    root = Path(__file__).resolve().parent.parent
    _, cfg, _ = load_finetune_config(root / "configs" / "finetune_lora.yaml")
    cfg = dataclasses.replace(
        cfg, compute_dtype=compute, decode_attention="fused_layers",
        adapter=dataclasses.replace(cfg.adapter, alpha=alpha))
    model = GPT(cfg, device=dev, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.2 * torch.randn(p.shape, device=dev, generator=g))
    return model


def _row_limit(want, compute, ulps=8):
    """float32: 1e-5 of each row's largest |value| (at least 1e-5);
    bfloat16: ``ulps`` ulps of it, as :func:`_mk_limit`."""
    w = want.float()
    rowmax = w.abs().amax(dim=-1, keepdim=True)
    if compute == "float32":
        return 1e-5 * rowmax.clamp_min(1.0)
    return _mk_limit(want, compute, ulps)


@pytest.mark.parametrize("alpha", [16.0, 64.0 / 3.0])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_megakernel_lora_matches_plain_at_the_flagship(cuda, compute, t, alpha):
    """The flagship (rank 8, all six sites; scale 2 and 8/3, which bf16
    cannot hold), B 4 on slots [0, 1, 2, 1]: the kernel's residual and
    caches against its plain version, over all 12 layers; the adapters
    move the tenant rows, and the base row equals the adapter-free kernel."""
    from dtc_tpu_torch.ops import decode_fused

    model = _flagship_lora_model(cuda, compute, alpha)
    stack = _lora_stack(model, 3, seed=11)
    ids = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=cuda)
    x, cache = _mk_inputs(model, 4, t, seed=12)
    idx = torch.tensor([2, 37, 300, 508], dtype=torch.int32, device=cuda)
    blocks = model.stage.blocks

    def run(fn, lora, lora_ids):
        c = {k: v.clone() for k, v in cache.items()}
        out = fn(x, blocks, c, idx, lora, lora_ids)
        torch.cuda.synchronize()
        return out, c

    before = decode_fused.launches
    got, c_got = run(decode_fused.fused_layers, stack, ids)
    assert decode_fused.launches == before + 1
    want, c_want = run(decode_fused.fused_layers_reference, stack, ids)
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    assert (diff <= _row_limit(want, compute)).all(), float(diff.max())
    _mk_check_cache(c_got, c_want, compute, model.cfg.n_heads)
    base, _ = run(decode_fused.fused_layers, None, None)
    assert torch.equal(base[0], got[0])
    assert all(float((got[r].float() - base[r].float()).abs().max()) > 0.01 for r in (1, 2, 3))


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_megakernel_lora_matches_plain(cuda, d, t, kv):
    """Small models (rank 6, alpha 16), per-row slots and a shared adapter,
    scalar and per-row frontiers: residual and caches against the plain
    version."""
    import dataclasses

    from dtc_tpu_torch.config.schema import AdapterConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_fused

    compute = "float32" if kv == "float32" else "bfloat16"
    base = _mk_model(cuda, d, compute, "auto" if kv != "int8" else "int8")
    model = GPT(dataclasses.replace(base.cfg, adapter=AdapterConfig(rank=6, alpha=16.0)),
                device=cuda)
    model.load_state_dict(base.state_dict())
    stack = _lora_stack(model, 3, seed=d + t)
    s = model.cfg.max_seq_len
    x, cache = _mk_inputs(model, 4, t, seed=d * 10 + t)
    ids = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=cuda)
    shared = {k: v[1].contiguous() for k, v in stack.items()}
    for idx in (torch.tensor([0, s - t, s + 5, 17], dtype=torch.int32, device=cuda),
                torch.tensor(s - t, dtype=torch.int32, device=cuda)):
        for lora, lora_ids in ((stack, ids), (shared, None)):
            c1 = {k: v.clone() for k, v in cache.items()}
            c2 = {k: v.clone() for k, v in cache.items()}
            got = decode_fused.fused_layers(x, model.stage.blocks, c1, idx, lora, lora_ids)
            want = decode_fused.fused_layers_reference(x, model.stage.blocks, c2, idx, lora,
                                                       lora_ids)
            torch.cuda.synchronize()
            _mk_assert_close(got, want, compute, f"out at {idx.tolist()}")
            _mk_check_cache(c1, c2, compute, 4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_megakernel_lora_rows_are_independent_and_deterministic(cuda, compute):
    """With per-row adapter slots: two runs give the same bits; window row j
    equals a single-token step at frontier + j; a row alone equals the row
    in the batch (the serving engine's bf16 solo identity rests on it)."""
    import dataclasses

    from dtc_tpu_torch.config.schema import AdapterConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_fused

    base = _mk_model(cuda, 32, compute, "auto", n_layers=3)
    model = GPT(dataclasses.replace(base.cfg, adapter=AdapterConfig(rank=8, alpha=21.0)),
                device=cuda)
    model.load_state_dict(base.state_dict())
    stack = _lora_stack(model, 4, seed=5)
    ids = torch.tensor([3, 0, 1, 3], dtype=torch.int32, device=cuda)
    x, cache = _mk_inputs(model, 4, 4, seed=6)
    idx = torch.tensor([3, 20, 0, 41], dtype=torch.int32, device=cuda)
    blocks = model.stage.blocks

    def run(xx, cc, ii, lid):
        c = {k: v.clone() for k, v in cc.items()}
        out = decode_fused.fused_layers(xx, blocks, c, ii, stack, lid)
        torch.cuda.synchronize()
        return out, c

    out1, c1 = run(x, cache, idx, ids)
    out2, c2 = run(x, cache, idx, ids)
    assert torch.equal(out1, out2) and all(torch.equal(c1[k], c2[k]) for k in c1)
    seq = {k: v.clone() for k, v in cache.items()}
    for j in range(4):
        one = decode_fused.fused_layers(x[:, j:j + 1].contiguous(), blocks, seq, idx + j,
                                        stack, ids)
        assert torch.equal(one[:, 0], out1[:, j]), j
    for r in range(4):
        row_cache = {k: v[:, r:r + 1].contiguous() if k != "index" else v
                     for k, v in cache.items()}
        alone, _ = run(x[r:r + 1].contiguous(), row_cache, idx[r:r + 1], ids[r:r + 1].contiguous())
        assert torch.equal(alone[0], out1[r]), r


def test_generate_with_lora_on_cuda_matches_cpu_fp32(cuda):
    """float32 (TF32 off): generate() with an adapter under fused_layers on
    the card, one megakernel launch per decode step, emits the CPU's
    tokens."""
    from dtc_tpu_torch.adapters import init_lora
    from dtc_tpu_torch.config.schema import AdapterConfig
    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=97, d_model=64, n_layers=4, n_heads=2, d_ff=128,
                      max_seq_len=64, compute_dtype="float32", decode_attention="fused_layers",
                      adapter=AdapterConfig(rank=4, alpha=8.0))
    cpu = GPT(cfg, device="cpu", seed=3)
    gpu = GPT(cfg, device=cuda, seed=3)
    gpu.load_state_dict(cpu.state_dict())
    lora = init_lora(cpu, seed=4)
    g = torch.Generator().manual_seed(5)
    lora = {k: v if k.endswith("_a") else 0.5 * torch.randn(v.shape, generator=g)
            for k, v in lora.items()}
    prompt = [[5, 9, 1, 44, 2, 7]]
    m0 = decode_fused.launches
    out = generate(gpu, prompt, 12, lora={k: v.to(cuda) for k, v in lora.items()})
    assert decode_fused.launches - m0 == 11
    assert out.cpu().tolist() == generate(cpu, prompt, 12, lora=lora).tolist()
    assert out.cpu().tolist() != generate(cpu, prompt, 12).tolist()


@pytest.mark.parametrize("tc", [8, 40, 1000, 1024])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_block_kernels_match_plain(cuda, tc, dt, causal):
    """The zigzag ring's block kernels (TPU kernel rows 15-16): forward
    causal or not; the backward from a given lse and out, float32
    gradients whatever the inputs' dtype."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import grad_tolerance

    h, d = 4, 32
    q, k, v, do = _flash_case(cuda, 2, tc, h, d, dt, seed=tc)
    out, lse = fa.flash_block_forward(q, k, v, h, causal)
    want_out, want_lse = fa.flash_block_reference(q, k, v, h, causal)
    _assert_close(out, want_out, h)
    assert ((lse - want_lse).abs() <= 1e-5).all()
    grads = fa.flash_block_backward(q, k, v, want_out, want_lse + 0.5, do, h, causal)
    want = fa.flash_block_backward_reference(q, k, v, want_out, want_lse + 0.5, do, h, causal)
    for g_, w in zip(grads, want):
        assert g_.dtype == torch.float32
        limit = grad_tolerance(w.to(dt), h).to(cuda)
        assert ((g_ - w).abs() <= limit).all()


def test_ring_on_one_card_launches_the_block_kernels(cuda):
    """The zigzag ring over 4 virtual ranks on CUDA tensors: 2R+1 block
    forward and backward calls a rank, and the result of the same
    schedules on the plain block versions."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import ring_attention as ra

    q, k, v, do = (x.view(2, 512, 4, 32) for x in
                   _flash_case(cuda, 2, 512, 4, 32, torch.float32, seed=3))

    def run():
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ra.ring_causal_attention(*xs, ra.InProcessRing(4))
        return (out.detach(), *torch.autograd.grad(out, xs, do))

    f0, b0 = fa.block_fwd_launches, fa.block_bwd_launches
    got = run()
    assert (fa.block_fwd_launches - f0, fa.block_bwd_launches - b0) == (36, 36 * fa.BWD_KERNELS)
    real = fa.flash_block_forward, fa.flash_block_backward
    fa.flash_block_forward = fa.flash_block_reference
    fa.flash_block_backward = fa.flash_block_backward_reference
    try:
        want = run()
    finally:
        fa.flash_block_forward, fa.flash_block_backward = real
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("h,d", [(16, 8), (2, 24), (1, 144)])
def test_ring_raises_on_cuda_at_a_head_dim_without_kernels(cuda, h, d):
    """On CUDA tensors the zigzag ring runs the block kernels or raises, as
    the single-card flash path does: a head dim the kernels lack never
    falls back to plain blocks on the card."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import ring_attention as ra

    q = torch.randn(1, 32, h, d, device=cuda)
    f0 = fa.block_fwd_launches
    with pytest.raises(ValueError, match="ROADMAP.md §B" if d > 128 else "head_dim"):
        ra.ring_causal_attention(q, q, q, ra.InProcessRing(2))
    assert fa.block_fwd_launches == f0


def _overlap_case(dev, m, k, n, dt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, device=dev, generator=g).to(dt) for s in ((m, k), (k, n), (m, n))]


#: Ring shapes whose views TMA can all take (rows of 16-byte multiples at
#: 16-byte-aligned offsets), by (m, k, n, shard axis); the others mix in the
#: per-thread loader (odd blocks of 300 or 20 columns start off 16 bytes;
#: rows of 28 elements are 56 bytes).
_TMA_ONLY = {(*shape, sa) for shape in ((64, 128, 256), (640, 64, 256), (1024, 128, 128),
                                        (1024, 128, 512), (1024, 512, 128)) for sa in (0, 1)}
_TMA_ONLY.add((100, 200, 300, 0))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (100, 200, 300), (33, 20, 7),
                                   (640, 64, 256), (1024, 128, 128), (1024, 128, 512),
                                   (1024, 512, 128)])
@pytest.mark.parametrize("shard_axis", [0, 1])
@pytest.mark.parametrize("flip", [False, True])
def test_overlap_steps_match_plain(cuda, dt, m, k, n, shard_axis, flip):
    """The FSDP ring's step kernels (TPU kernel rows 17-18) over a ring of 4
    virtual ranks, a weight held as it is or transposed (``Dense.weight``'s
    layout): the float32 ring outputs within 1e-5 of each row's largest
    value (bf16 products are exact in float32), 2R² and R² launches, each
    on the route its plan names: float32 the CUDA-core tiles, bfloat16 the
    tensor cores by TMA, or, where a block or row cannot be taken by TMA
    (m 100 with the output sharded: blocks of 300 at 600-byte offsets; m
    33: blocks of 20 and 7), by the per-thread loader. m 1024 are the
    flagship's four sites at one rank's
    size (x (1024, 512 or 2048) a rank: q/k/v and out_proj (128, 128) a
    chunk, fc1 (128, 512), fc2 (512, 128))."""
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing
    from dtc_tpu_torch.parity import row_tolerance

    x, w, dy = _overlap_case(cuda, 4 * m, 4 * k, 4 * n, dt, seed=m)
    w = w.t().contiguous().t() if flip else w
    ring = InProcessRing(4)

    def run(ag=None, rs=None):
        y = oc.ring_ag_matmul(x, w, ring, shard_axis=shard_axis, step=ag)
        return (y, *oc.ring_backward(x, w, dy, ring, shard_axis=shard_axis, ag=ag, rs=rs))

    a0, r0 = oc.ag_launches, oc.rs_launches
    routes0 = dict(oc.route_launches)
    got = run()
    assert (oc.ag_launches - a0, oc.rs_launches - r0) == (32, 16)
    routes = {r: oc.route_launches[r] - routes0[r] for r in routes0}
    if dt == torch.float32:
        assert routes == {"cuda_cores": 48, "tma": 0, "threads": 0}
    elif (m, k, n, shard_axis) in _TMA_ONLY:
        assert routes == {"cuda_cores": 0, "tma": 48, "threads": 0}
    else:
        assert routes["cuda_cores"] == 0 and routes["threads"] > 0
        assert routes["tma"] + routes["threads"] == 48
    want = run(oc.ag_step_reference, oc.rs_step_reference)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert ((a - b).abs() <= row_tolerance(b, torch.float32).to(cuda)).all()


#: The dense sites of ``train_config_3d.yaml`` (data 4 × model 2) at one
#: model rank's Megatron widths, over a ring of 4: (site, token rows of
#: the 4 ranks, K, N, shard axis). A rank's x is (4·512, K); its chunk a
#: ring step q/k/v (128, 256), fc1 (128, 1024), out_proj (256, 128), fc2
#: (1024, 128).
SITES_3D = (("qkv", 8192, 512, 256, 0), ("fc1", 8192, 512, 1024, 0),
            ("out_proj", 8192, 256, 512, 1), ("fc2", 8192, 1024, 512, 1))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site,m,k,n,shard_axis", SITES_3D)
def test_overlap_steps_match_plain_at_the_3d_sites(cuda, dt, site, m, k, n, shard_axis):
    """The ring's step kernels at the DP×FSDP×TP sites over 4 virtual
    ranks, the weight in ``Dense.weight``'s layout (the TP slice
    transposed): float32 ring outputs within 1e-5 of each row's largest
    value, 2R² and R² launches, bf16 every launch on the tensor cores by
    TMA, float32 on the CUDA cores."""
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing
    from dtc_tpu_torch.parity import row_tolerance

    x, w, dy = _overlap_case(cuda, m, k, n, dt, seed=k + n)
    w = w.t().contiguous().t()
    ring = InProcessRing(4)

    def run(ag=None, rs=None):
        y = oc.ring_ag_matmul(x, w, ring, shard_axis=shard_axis, step=ag)
        return (y, *oc.ring_backward(x, w, dy, ring, shard_axis=shard_axis, ag=ag, rs=rs))

    a0, r0 = oc.ag_launches, oc.rs_launches
    routes0 = dict(oc.route_launches)
    got = run()
    assert (oc.ag_launches - a0, oc.rs_launches - r0) == (32, 16)
    routes = {r: oc.route_launches[r] - routes0[r] for r in routes0}
    route = "cuda_cores" if dt == torch.float32 else "tma"
    assert routes == dict({"cuda_cores": 0, "tma": 0, "threads": 0}, **{route: 48})
    want = run(oc.ag_step_reference, oc.rs_step_reference)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert ((a - b).abs() <= row_tolerance(b, torch.float32).to(cuda)).all()


def _deep_steps(dev, seed=0):
    """fc2's out-mode forward step (x (1024, 2048) @ a (2048, 128) chunk,
    the transposed weight) and fc1's dw step (x (1024, 512)'s 128-column
    block against dy (1024, 2048)) at one rank's size, bfloat16: contractions
    of 2048 and 1024 that the plan splits over a cluster."""
    x, dy = (t.to(torch.bfloat16) for t in _overlap_case(dev, 1024, 2048, 2048,
                                                         torch.float32, seed)[::2])
    w = torch.randn(512, 2048, device=dev, generator=torch.Generator(device=dev).manual_seed(
        seed)).to(torch.bfloat16)[:128].t()
    return x, w, dy


def test_overlap_tma_step_launches_from_a_thread_without_cuda_work(cuda):
    """The ring's "tma" route encodes its tensor maps with
    cuTensorMapEncodeTiled, which needs the device's context current on the
    calling thread: a step launched as the first CUDA work of a fresh thread
    (as a ring step would be on autograd's backward thread) gives the main
    thread's bits."""
    import threading

    from dtc_tpu_torch.ops import overlap_collectives as oc

    x, w, _ = _deep_steps(cuda, seed=3)
    outs = [torch.zeros(1024, 128, device=cuda) for _ in range(2)]
    r0 = oc.route_launches["tma"]

    def step(out):
        oc.ag_step(x, w, out, src=0, slice_x=False, slice_out=True, w_t=False, accumulate=False)

    step(outs[0])
    torch.cuda.synchronize()
    err = []

    def fresh():
        try:
            step(outs[1])
        except RuntimeError as e:
            err.append(e)

    th = threading.Thread(target=fresh)
    th.start()
    th.join(timeout=120)
    torch.cuda.synchronize()
    assert not th.is_alive() and not err, f"the launch raised on a fresh thread: {err}"
    assert oc.route_launches["tma"] == r0 + 2
    assert torch.equal(outs[0], outs[1])


def test_overlap_cluster_split_steps_are_bit_equal_run_to_run(cuda):
    """A step whose contraction is split over the blocks of a cluster sums
    the partials in cluster-rank order: two runs give the same bits."""
    from dtc_tpu_torch.ops import overlap_collectives as oc

    x, w, dy = _deep_steps(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ag_plan = oc.ag_plan(x, w, src=0, slice_x=False, w_t=False, sms=sms)
    rs_plan = oc.rs_plan(x[:, :512], dy, j=1, blk=128, slice_a=True, sms=sms)
    assert ag_plan.route == rs_plan.route == "tma"
    assert ag_plan.split > 1 and rs_plan.split > 1
    outs = []
    for _ in range(2):
        out = torch.full((1024, 128), float("nan"), device=cuda)
        oc.ag_step(x, w, out, src=0, slice_x=False, slice_out=True, w_t=False, accumulate=False)
        acc = torch.ones(128, 2048, device=cuda)
        outs.append((out, oc.rs_step(x[:, :512], dy, acc, j=1, blk=128, slice_a=True)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_overlap_tensor_core_step_at_k2048_within_the_float32_limit(cuda):
    """bf16 products are exact in float32 and the kernel sums in float32, so
    a tensor-core step over a contraction of 2048 stays within the float32
    limit of the plain version (1e-5 of each row's largest value)."""
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.parity import row_tolerance

    x, w, _ = _deep_steps(cuda, seed=1)
    r0 = dict(oc.route_launches)
    out = torch.zeros(1024, 128, device=cuda)
    oc.ag_step(x, w, out, src=0, slice_x=False, slice_out=True, w_t=False, accumulate=False)
    assert oc.route_launches["tma"] == r0["tma"] + 1
    want = torch.zeros_like(out)
    oc.ag_step_reference(x, w, want, src=0, slice_x=False, slice_out=True, w_t=False,
                         accumulate=False)
    assert ((out - want).abs() <= row_tolerance(want, torch.float32).to(cuda)).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_overlap_planted_faults_land_over_the_limit(cuda, dt):
    """chip_smoke's planted faults (chunk order off by one step, ``w_t``
    ignored on a non-square chunk, the arriving accumulator dropped,
    partials rounded to bf16) break the comparison the kernels pass."""
    import chip_smoke

    r = chip_smoke.overlap_case("gpu_test", 2, 50, 96, 160, 0, {torch.float32: "float32",
                                                               torch.bfloat16: "bfloat16"}[dt],
                                seed=5)
    assert all(v > 1.0 for v in r["fault_over_limit"].values())
    assert all(v[1] <= 1.0 for v in r["errors"].values())


def test_overlap_op_on_cuda_launches_or_raises(cuda):
    """On CUDA tensors the op launches the kernels or raises: operands it
    cannot take (float16, mixed dtypes, a CPU accumulator) raise, and the
    model's dense sites under an overlapped FSDP ring launch one step
    kernel a ring step."""
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing

    x, w, _ = _overlap_case(cuda, 32, 64, 128, torch.float32)
    a0 = oc.ag_launches
    with pytest.raises(ValueError):
        oc.overlap_dense_matmul(x.half(), w.half(), shard_axis=0, ring=InProcessRing(4))
    with pytest.raises(ValueError):
        oc.overlap_dense_matmul(x, w.to(torch.bfloat16), shard_axis=0, ring=InProcessRing(4))
    with pytest.raises(ValueError):
        oc.rs_step(x, x, torch.zeros(64, 64), j=0, blk=64, slice_a=True)
    assert oc.ag_launches == a0
    y = oc.overlap_dense_matmul(x, w, shard_axis=1, ring=InProcessRing(4))
    assert oc.ag_launches - a0 == 16
    assert ((y - x @ w).abs() <= 1e-5 * (x @ w).abs().amax(-1, keepdim=True)).all()


def test_fsdp_overlapped_training_on_cuda_matches_unsharded(cuda):
    """A small float32 model under an overlapped FSDP ring of 4 virtual
    ranks: the dense sites launch the kernels (R² forward and 2R² backward
    steps a site and call), and 3 steps' losses equal the unsharded run's
    within 1e-5."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing
    from dtc_tpu_torch.parallel.fsdp import FSDP
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step

    cfg = ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                      max_seq_len=64, dropout=0.0, compute_dtype="float32",
                      attention="flash", collectives="overlapped")
    opt_cfg = OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    batches = [torch.randint(0, 97, (8, 65), device=cuda, generator=g) for _ in range(3)]
    losses = {}
    for state in (None, FSDP(InProcessRing(4))):
        model = GPT(cfg, device=cuda, seed=0)
        opt = create_optimizer(model.parameters(), opt_cfg, 3)
        a0, r0 = oc.ag_launches, oc.rs_launches
        losses[state is None] = [float(train_step(model, opt, b[:, :-1], b[:, 1:], None, state))
                                 for b in batches]
        sites = 3 * cfg.n_layers * 6
        assert (oc.ag_launches - a0, oc.rs_launches - r0) == (
            (0, 0) if state is None else (sites * 32, sites * 16))
    assert max(abs(a - b) for a, b in zip(losses[True], losses[False])) <= 1e-5


# ---------------------------------------------------------------------------
# tensor parallelism on the card: two gloo ranks sharing it
# ---------------------------------------------------------------------------

def _tp_worker(out_dir: str) -> None:
    """One of two ranks (this file run as a script, torchrun's environment
    set by ``tp_pair``), every tensor on ``cuda:0``: the vocab-parallel head
    + CE over the model group of 2 and one tensor-parallel block, forward
    and gradients, in float32 and bf16; rank 0 also computes the whole
    versions (one-rank ``fused_head_ce``, the whole block) on the same
    inputs. Writes ``tp_r<rank>.pt``."""
    from pathlib import Path

    from dtc_tpu_torch.models.gpt import Block
    from dtc_tpu_torch.ops.fused_ce import fused_head_ce
    from dtc_tpu_torch.parallel.tensor import TensorParallel, copy_to_model
    from dtc_tpu_torch.parity import tp_shards
    from dtc_tpu_torch.utils import dist as dist_utils

    dev = dist_utils.initialize("cuda:0", "gloo")
    rank = dist_utils.rank()
    tp = TensorParallel((0, 1), None)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        g = torch.Generator(device=dev).manual_seed(7)
        n, d, vocab = 4096 + 300, 512, 1000            # two CE chunks; padded 1024
        h = torch.randn(n, d, device=dev, generator=g).to(dt)
        w = 0.05 * torch.randn(1024, d, device=dev, generator=g)
        b = 0.1 * torch.randn(1024, device=dev, generator=g)
        y = torch.randint(0, vocab, (n,), device=dev, generator=g)
        y[:3] = torch.tensor([3, 700, 999])              # both ranks' columns, the pad's rank

        def ce(h, w, b, group):
            h = h.clone().requires_grad_(True)
            w, b = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
            src = h if group is None else copy_to_model(h, group)
            loss = fused_head_ce(src, w, b, y, vocab, group)
            loss.backward()
            return [loss.detach(), h.grad, w.grad, b.grad]

        cols = slice(rank * 512, (rank + 1) * 512)
        out[f"ce_{name}"] = ce(h, w[cols], b[cols], tp)
        if rank == 0:
            out[f"ce_{name}_whole"] = ce(h, w, b, None)

        cfg = ModelConfig(vocab_size=vocab, d_model=512, n_layers=1, n_heads=16, d_ff=2048,
                          max_seq_len=512, dropout=0.0, compute_dtype=name, attention="auto")
        whole = Block(cfg, dev)
        with torch.no_grad():
            for p in whole.parameters():
                p.copy_(0.05 * torch.randn(p.shape, device=dev, generator=g))
        part = Block(cfg, dev, tp)
        part.load_state_dict(tp_shards(whole.state_dict(), rank, 2))
        x = torch.randn(4, 512, 512, device=dev, generator=g).to(dt)
        dy = torch.randn(4, 512, 512, device=dev, generator=g).to(dt)
        for tag, blk in (("part", part), ("whole", whole)) if rank == 0 else (("part", part),):
            xi = x.clone().requires_grad_(True)
            y_ = blk(xi, train=True)
            y_.backward(dy)
            out[f"block_{name}_{tag}"] = [y_.detach(), xi.grad] + [
                p.grad for _, p in sorted(blk.named_parameters())]
        out[f"block_{name}_names"] = [n_ for n_, _ in sorted(part.named_parameters())]
    out.update(_fsdp_ring_pair(dev, rank))
    torch.save({k: [t.cpu() if torch.is_tensor(t) else t for t in v] for k, v in out.items()},
               Path(out_dir) / f"tp_r{rank}.pt")
    dist_utils.teardown()


def _fsdp_ring_pair(dev, rank: int) -> dict:
    """The FSDP ring's transport between the two ranks on the card: one
    ``DistRing`` exchange of CUDA tensors under gloo (a chunk sent to the
    other rank, a transposed view kept home), and the overlapped op over
    the two ranks (this rank's rows and weight chunk, forward and
    gradients) beside the same op over 2 virtual ranks of the whole."""
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import DistRing, InProcessRing

    ring = DistRing((0, 1))
    x = torch.arange(120.0, device=dev).reshape(3, 40) + 1000 * rank
    res = {"ring_exchange": [x, *ring.exchange(((1, 0), (0, 1)), [x, x.t()])]}
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(5)
        xw, w, dy = (torch.randn(*s, device=dev, generator=g).to(dt)
                     for s in ((256, 128), (128, 192), (256, 192)))
        rows = slice(rank * 128, (rank + 1) * 128)
        for sa in (0, 1):
            for tag, ring_, xi, wi, dyi in (
                    ("rank", ring, xw[rows], w.chunk(2, sa)[rank].contiguous(), dy[rows]),
                    ("whole", InProcessRing(2), xw, w, dy)):
                xi, wi = xi.clone().requires_grad_(True), wi.clone().requires_grad_(True)
                y = oc.overlap_dense_matmul(xi, wi, shard_axis=sa, ring=ring_)
                y.backward(dyi)
                res[f"op_{dt}_{sa}_{tag}"] = [y.detach(), xi.grad, wi.grad]
    return res


@pytest.fixture(scope="module")
def tp_pair(kernels_built, tmp_path_factory):
    """The two ranks of :func:`_tp_worker`, run once; their results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("tp_pair")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(out)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port,
                 PYTHONPATH=str(root)))
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"tp_r{r}.pt") for r in range(2)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_vocab_parallel_ce_on_cuda_matches_one_rank(tp_pair, dt):
    """Over 2 gloo ranks on the card: the loss and dh equal one rank's
    ``fused_head_ce``, each rank's dW / db columns the whole one's
    (float32 1e-5; bf16 ``parity.row_tolerance``)."""
    from dtc_tpu_torch.parity import row_tolerance

    want = tp_pair[0][f"ce_{dt}_whole"]
    dtype = getattr(torch, dt)
    for rank in range(2):
        got = tp_pair[rank][f"ce_{dt}"]
        assert abs(float(got[0]) - float(want[0])) <= 1e-5 * max(1.0, abs(float(want[0])))
        cols = slice(rank * 512, (rank + 1) * 512)
        for g, w in ((got[1], want[1]), (got[2], want[2][cols]),
                     (got[3][None], want[3][cols][None])):
            assert ((g.float() - w.float()).abs() <= row_tolerance(w, dtype)).all()
    assert float(tp_pair[1][f"ce_{dt}"][3][1000 - 512:].abs().max()) == 0.0  # the pad


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_tp_block_on_cuda_matches_the_whole_block(tp_pair, dt):
    """A block split over 2 gloo ranks on the card (8 heads of 32 a rank on
    the flash kernels, d_ff 1024 a rank): its output and input gradient
    equal the whole block's (``parity.attention_tolerance`` /
    ``grad_tolerance``), each parameter gradient the whole one's slice
    within ``parity.row_tolerance`` of the largest value of its site's
    weight and bias gradients together: each entry is a sum over every
    token, so its error follows the size of the terms, not of the entry
    (as ``grad_tolerance`` argues; the k bias's terms cancel exactly)."""
    from dtc_tpu_torch.parallel.sharding import tp_shard_dim
    from dtc_tpu_torch.parity import grad_tolerance, row_tolerance

    dtype = getattr(torch, dt)
    want = tp_pair[0][f"block_{dt}_whole"]
    names = tp_pair[0][f"block_{dt}_names"]
    for rank in range(2):
        got = tp_pair[rank][f"block_{dt}_part"]
        assert ((got[0].float() - want[0].float()).abs()
                <= attention_tolerance(want[0], 16)).all()
        assert ((got[1].float() - want[1].float()).abs() <= grad_tolerance(want[1], 16)).all()
        wants = {}
        for name, w in zip(names, want[2:]):
            dim = tp_shard_dim("stage.blocks.0." + name)
            wants[name] = w if dim is None else w.chunk(2, dim)[rank]
        for name, g in zip(names, got[2:]):
            site = torch.cat([wants[name.rsplit(".", 1)[0] + "." + leaf].reshape(-1)
                              for leaf in ("weight", "bias")])
            limit = row_tolerance(site[None], dtype)[0, 0]
            assert ((g.float() - wants[name].float()).abs() <= limit).all(), name


def test_dist_ring_carries_cuda_tensors_between_gloo_ranks(tp_pair):
    """Two gloo ranks on the card: a ``DistRing`` exchange hands each rank
    the other's CUDA tensor (through host buffers: gloo moves CUDA tensors
    only in collectives) and keeps the self-pair's transposed view; the
    overlapped op over the two ranks (the FSDP ring's kernels, this rank's
    rows and weight chunk) equals the op over 2 virtual ranks of the whole
    within ``parity.row_tolerance``, forward and gradients, both shard
    axes, float32 and bf16."""
    from dtc_tpu_torch.parity import row_tolerance

    for rank in range(2):
        mine, got, home = tp_pair[rank]["ring_exchange"]
        assert torch.equal(got, tp_pair[1 - rank]["ring_exchange"][0])
        assert torch.equal(home, mine.t())
        for dt in (torch.float32, torch.bfloat16):
            for sa in (0, 1):
                got = tp_pair[rank][f"op_{dt}_{sa}_rank"]
                want = tp_pair[0][f"op_{dt}_{sa}_whole"]
                rows = slice(rank * 128, (rank + 1) * 128)
                pieces = (want[0][rows], want[1][rows], want[2].chunk(2, sa)[rank])
                for a, b in zip(got, pieces):
                    assert a.dtype == dt and a.shape == b.shape
                    assert ((a.float() - b.float()).abs() <= row_tolerance(b, dt)).all()


def test_flagship_width_resume_and_eval_are_bit_exact(cuda, tmp_path):
    """``chip_smoke.py`` phase 24(a) at fewer steps and 2 layers: the
    flagship's widths (d_model 512, 16 heads of 32, T 512, B 8, dropout
    0.1, bf16 compute) with checkpoints and eval every 3 steps; 3 steps and
    a resume to 6 give the uninterrupted run's losses, eval losses and
    parameters bit for bit, and every flash launch is "tc"."""
    from pathlib import Path

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    root = Path(__file__).resolve().parent.parent
    tcfg, mcfg, ocfg = load_config(root / "configs" / "train_config_dp.yaml")
    mcfg = dataclasses.replace(mcfg, n_layers=2)

    def run(name, steps):
        cfg = dataclasses.replace(
            tcfg, dataset="synthetic", obs=dataclasses.replace(tcfg.obs, enabled=False),
            steps=steps, warmup_steps=2, log_every=3, checkpoint_every=3, eval_every=3,
            eval_batches=1, output_dir=str(tmp_path / name),
            checkpoint_dir=str(tmp_path / f"{name}_ckpt"))
        return train(cfg, mcfg, ocfg)

    fa.fwd_route_launches.update(dict.fromkeys(fa.fwd_route_launches, 0))
    full = run("full", 6)
    part = run("part", 3)
    resumed = run("part", 6)
    assert part.losses + resumed.losses == full.losses
    assert part.eval_losses + resumed.eval_losses == full.eval_losses
    assert all(torch.equal(p, q) for p, q in zip(full.model.parameters(),
                                                 resumed.model.parameters()))
    assert fa.fwd_route_launches["tc"] > 0 and fa.fwd_route_launches["fma"] == 0


def _lora_case(b_scale: float):
    """``finetune_lora.yaml``'s model (12 layers, d_model 512, 16 heads of
    32, bf16 compute, rank 8 on all six sites) at dropout 0, its base drawn
    once on the CPU (a CUDA generator draws other numbers), factors with A
    lecun-sized and B ``b_scale`` times that, and a B 2, T 512 batch."""
    from pathlib import Path

    from dtc_tpu_torch.adapters.lora import lora_shapes
    from dtc_tpu_torch.config.loader import load_finetune_config
    from dtc_tpu_torch.models.gpt import GPT

    root = Path(__file__).resolve().parent.parent
    _, mcfg, _ = load_finetune_config(root / "configs" / "finetune_lora.yaml")
    mcfg = dataclasses.replace(mcfg, dropout=0.0)
    g = torch.Generator().manual_seed(3)
    factors = {k: torch.randn(shape, generator=g) / shape[-1] ** 0.5
               * (b_scale if k.endswith("_b") else 1.0) for k, shape in lora_shapes(mcfg).items()}
    tokens = torch.randint(0, mcfg.vocab_size, (2, mcfg.max_seq_len + 1), generator=g)
    return mcfg, GPT(mcfg, device="cpu", seed=0).state_dict(), factors, tokens


def _lora_step(mcfg, base, factors, tokens, dev):
    """One forward with targets and its backward on ``dev`` from ``base``:
    the loss, the factors' gradients (on the CPU), the flash launches
    (forward, backward) and whether the base got no gradient."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import flash_attention as fa

    model = GPT(mcfg, device=dev, seed=0).requires_grad_(False)
    model.load_state_dict(base)
    fac = {k: v.clone().to(dev).requires_grad_(True) for k, v in factors.items()}
    t = tokens.to(dev)
    fa.fwd_launches = fa.bwd_launches = 0
    for counts in (fa.fwd_route_launches, fa.dq_route_launches, fa.dkv_route_launches):
        counts.update(dict.fromkeys(counts, 0))
    loss = model(t[:, :-1], train=True, targets=t[:, 1:], lora=fac)
    loss.backward()
    return (float(loss.detach()), {k: v.grad.detach().cpu() for k, v in fac.items()},
            (fa.fwd_launches, fa.bwd_launches), all(p.grad is None for p in model.parameters()))


def _check_lora_launches(mcfg, launches):
    from dtc_tpu_torch.ops import flash_attention as fa

    assert launches == (mcfg.n_layers, mcfg.n_layers * fa.BWD_KERNELS)
    assert fa.fwd_route_launches["tc"] == mcfg.n_layers and fa.fwd_route_launches["fma"] == 0
    assert fa.dq_route_launches["tc"] == fa.dkv_route_launches["tc"] == mcfg.n_layers


def test_lora_training_step_on_cuda_matches_cpu(cuda):
    """One LoRA finetune step's forward and backward at the flagship's
    widths (:func:`_lora_case`) with factors of a finetuned adapter's size
    (B a hundredth of A's scale: AdamW moves a B entry by about lr a step,
    ~0.019 over phase 25's 62 steps at lr 3e-4; nonzero, so A's gradients
    are not zero): on the card against the CPU, the loss within 1e-2
    relative and each factor's gradient within the flash kernels' bf16
    gradient limit (``parity.grad_tolerance``: ``BF16_ULPS`` ulps of the
    tensor's largest value); the base gets no gradient; 12 forward and 24
    backward flash launches, all "tc". With B as large as A the two
    devices part by more than that limit, and
    :func:`test_lora_training_step_on_cuda_is_as_near_float64_as_cpu`
    holds both against a float64 reference."""
    from dtc_tpu_torch.parity import grad_tolerance

    mcfg, base, factors, tokens = _lora_case(0.01)
    l_cpu, g_cpu, _, frozen_cpu = _lora_step(mcfg, base, factors, tokens, "cpu")
    l_gpu, g_gpu, launches, frozen_gpu = _lora_step(mcfg, base, factors, tokens, cuda)
    assert frozen_cpu and frozen_gpu
    _check_lora_launches(mcfg, launches)
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    for k, want in g_cpu.items():
        flat = want.reshape(1, -1, want.shape[-1])
        limit = grad_tolerance(flat.to(torch.bfloat16), 1).reshape(want.shape)
        assert ((g_gpu[k] - want).abs() <= limit).all(), k


#: How much farther (normwise) from the float64 gradient the card's bf16
#: factor gradients may lie than the CPU's, at B as large as A: both
#: devices' bf16 roundings are of one size, so the ratio sits near 1
#: (``tools/lora_grad_agreement.py`` on an H100: see PERF.md §6); a
#: misplaced rounding point or a wrong product on the card moves it far
#: past this.
LORA_F64_RATIO = 1.5


def test_lora_training_step_on_cuda_is_as_near_float64_as_cpu(cuda):
    """:func:`_lora_case` with B as large as A (a delta the size of the
    dense output it joins), where the card's and the CPU's bf16 factor
    gradients part by a quarter of the largest gradient over 12 layers:
    each factor's gradient on the card lies no farther (normwise) from a
    plain float64 model's (``tools/lora_grad_agreement.py``'s
    ``lora_grads_float64``) than ``LORA_F64_RATIO`` times the CPU's bf16
    gradient does, the loss within 1e-2 of float64's on both devices; 12
    forward and 24 backward flash launches, all "tc"."""
    from tools.lora_grad_agreement import lora_grads_float64

    mcfg, base, factors, tokens = _lora_case(1.0)
    l64, g64 = lora_grads_float64(base, factors, tokens, mcfg)
    l_cpu, g_cpu, _, _ = _lora_step(mcfg, base, factors, tokens, "cpu")
    l_gpu, g_gpu, launches, frozen = _lora_step(mcfg, base, factors, tokens, cuda)
    assert frozen
    _check_lora_launches(mcfg, launches)
    assert abs(l_cpu - l64) <= 1e-2 * l64 and abs(l_gpu - l64) <= 1e-2 * l64, (l_cpu, l_gpu, l64)
    ratios = {k: float((g_gpu[k].double() - want).norm() / (g_cpu[k].double() - want).norm())
              for k, want in g64.items()}
    assert max(ratios.values()) <= LORA_F64_RATIO, ratios


def test_bf16_mixed_optimizer_step_on_cuda_matches_cpu(cuda):
    """``precision: bf16_mixed`` updates on the card: 3 clip + AdamW steps
    over bfloat16 and float32 parameters from the same gradients give the
    CPU's masters and moments within 1e-6, each parameter its master
    rounded bit for bit."""
    from dtc_tpu_torch.train.optimizer import create_optimizer

    cfg = OptimConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0, precision="bf16_mixed")
    g = torch.Generator().manual_seed(5)
    shapes = [((64, 48), torch.bfloat16), ((48,), torch.float32), ((300,), torch.bfloat16)]
    init = [torch.randn(s, generator=g).to(dt) for s, dt in shapes]
    grads = [[torch.randn(s, generator=g).to(dt) for s, dt in shapes] for _ in range(3)]
    opts = {}
    for dev in ("cpu", cuda):
        params = [p.clone().to(dev).requires_grad_(True) for p in init]
        opt = create_optimizer(params, cfg, skip_nonfinite=True)
        for step in grads:
            for p, gr in zip(params, step):
                p.grad = gr.to(dev)
            opt.step()
        opts[str(dev)] = opt
    cpu, gpu = opts["cpu"], opts[str(cuda)]
    for a, b in zip(gpu.masters + gpu.mu + gpu.nu, cpu.masters + cpu.mu + cpu.nu):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
    for o in (cpu, gpu):
        assert all(torch.equal(p.detach(), m.to(p.dtype)) for p, m in zip(o.params, o.masters))
    assert int(gpu.count) == int(cpu.count) == 3


def test_devprof_capture_attributes_every_flash_kernel(cuda, tmp_path):
    """The trainer's device-profile window of 2 steps at small width (bf16,
    2 layers of 4 heads of 64, T 256, dropout 0.1), read by
    ``analyze_capture``: every flash kernel attributed to ``attn_kernel``,
    the forward's in phase ``fwd`` and the dq and dk/dv kernels in ``bwd``,
    all on the tensor cores, 2 forward and 4 backward a step; every matrix
    product attributed, the unattributed share at most 0.10; the kernels'
    summed time within 1% of ``key_averages()``'s device total."""
    import re

    from dtc_tpu_torch.config.schema import ObsConfig, TrainConfig
    from dtc_tpu_torch.obs import analyze_capture, find_captures
    from dtc_tpu_torch.obs.devprof import classify_scope, structural_gates
    from dtc_tpu_torch.train.trainer import train

    mcfg = ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, d_ff=1024,
                       max_seq_len=256, dropout=0.1, compute_dtype="bfloat16")
    tcfg = TrainConfig(seed=0, parallel="dp", batch=4, steps=4, log_every=2,
                       output_dir=str(tmp_path), dataset="synthetic", warmup_steps=1,
                       obs=ObsConfig(devprof_every=2))
    train(tcfg, mcfg, OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0))
    caps = find_captures(str(tmp_path / "obs" / "devprof"))
    assert len(caps) == 1
    cap = analyze_capture(caps[0])
    att, meta = cap["attribution"], cap["meta"]
    assert meta["steps"] == 2
    kinds = {"fwd": 0, "bwd": 0}
    for r in cap["rows"]:
        m = re.search(r"\bflash_(fwd|dq|dkv|bwd_dq|bwd_dkv)(_tc)?_kernel\b", r.name)
        if m is None:
            continue
        part = "fwd" if m.group(1) == "fwd" else "bwd"
        assert m.group(2) == "_tc", r.name
        assert classify_scope(r.scope) == ("attn_kernel", part), (r.name, r.scope)
        kinds[part] += 1
    assert kinds == {"fwd": 2 * 2, "bwd": 4 * 2}
    gates = structural_gates(att)
    assert gates["all_dot_fusions_attributed"] and gates["unattributed_share_ok"], gates
    assert abs(att.total_s - meta["profiler_device_s"]) <= 0.01 * meta["profiler_device_s"]



@pytest.mark.parametrize("backend", ["fused", "fused_layers"])
def test_chaos_serving_faults_on_the_card_cache(cuda, backend):
    """The flagship (``serve_config.yaml`` + ``model_config.yaml``, bf16)
    under ``backend``: the chaos corruption overwrites the first completed
    page of the card's K cache in place (the same storage, every layer at
    that page the value 123.25 rounds to), and the verifier evicts the
    request in that iteration, before a token computed from the page is
    emitted; a serve whose only fault is poisoned logits retries once from
    the pre-step cache and gives the clean run's tokens."""
    from pathlib import Path

    import numpy as np

    from dtc_tpu_torch.config.loader import load_serve_config
    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.serve import Request, ServingEngine

    root = Path(__file__).resolve().parents[1]
    scfg, mcfg = load_serve_config(root / "configs" / "serve_config.yaml",
                                   model_overrides={"decode_attention": backend})
    model = GPT(mcfg, device=cuda, seed=0)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, mcfg.vocab_size, size=n).tolist() for n in (40, 21)]

    def run(chaos, **over):
        eng = ServingEngine(model, dataclasses.replace(scfg, chaos=chaos, **over))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=24))
        return eng

    clean = run(ChaosConfig())
    clean.run()
    poisoned = run(ChaosConfig(enabled=True, serve_poison_logits_at_step=3))
    poisoned.run()
    assert poisoned.counters["serve_retries"] == 1
    assert ({rid: r.tokens for rid, r in poisoned.results.items()}
            == {rid: r.tokens for rid, r in clean.results.items()})

    eng = run(ChaosConfig(enabled=True, serve_corrupt_page_at_step=2), verify_pages_every=1)
    eng.step()
    ptr = eng.cache["k"].data_ptr()
    tokens = {rid: list(r.tokens) for rid, r in eng.results.items()}
    seen = {}
    verify = eng._verify_pages

    def spy():
        slot = next(i for i, s in enumerate(eng.slots) if s.rid == "r0")
        seen["page"] = eng.cache["k"][:, slot, 0:scfg.page_size].clone()
        verify()
    eng._verify_pages = spy
    eng.step()
    want = torch.tensor(123.25, dtype=eng.cache["k"].dtype, device=cuda)
    assert torch.all(seen["page"] == want) and eng.cache["k"].data_ptr() == ptr
    assert eng.counters["serve_corruptions"] == 1 and eng.results["r0"].n_evictions == 1
    assert eng.results["r0"].tokens == tokens["r0"]
    eng.run()
    assert all(r.state.value == "done" for r in eng.results.values())


if __name__ == "__main__":
    import sys

    _tp_worker(sys.argv[1])


def test_snapshot_pinned_copies_leave_the_losses_bit_equal(cuda, tmp_path):
    """Elastic training's snapshots on the card (device clones, the copy
    stream into pinned buffers behind a CUDA event, the commit thread) move
    no loss bit: at the flagship's widths with 2 layers (bf16, dropout
    0.1), snapshots every step give the losses of a run whose cadence never
    fires, and a host killed at step 4 replays them bit for bit."""
    from pathlib import Path

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.config.schema import ChaosConfig, ElasticConfig, ResilienceConfig
    from dtc_tpu_torch.train.trainer import train

    root = Path(__file__).resolve().parent.parent
    tcfg, mcfg, ocfg = load_config(root / "configs" / "train_config_dp.yaml")
    mcfg = dataclasses.replace(mcfg, n_layers=2)

    def run(name, every, chaos=ChaosConfig()):
        el = ElasticConfig(enabled=True, snapshot_every=every, keep=4, n_virtual_hosts=2)
        cfg = dataclasses.replace(
            tcfg, parallel="fsdp", dataset="synthetic", steps=8, warmup_steps=1, log_every=2,
            checkpoint_every=100, output_dir=str(tmp_path / name),
            checkpoint_dir=str(tmp_path / f"{name}_ckpt"),
            resilience=ResilienceConfig(elastic=el, chaos=chaos))
        return train(cfg, mcfg, ocfg)

    quiet = run("quiet", 1000)
    assert run("every", 1).losses == quiet.losses
    kill = run("kill", 1, ChaosConfig(enabled=True, kill_host_at_step=4, elastic_target_host=0))
    assert kill.losses == quiet.losses and kill.mesh.shape["data"] == 4


def test_snapshot_restore_onto_the_card_equals_the_snapshot(cuda):
    """A snapshot of card tensors (bf16 and float32, a device count, a CUDA
    generator's state) is the state at ``begin``: updated in place after
    it, the restore onto the card gives the values and dtypes of the
    moment it was taken, on the card, through the ring mirror too."""
    from dtc_tpu_torch.resilience import SnapshotStore, VirtualHosts, VirtualMesh

    gen = torch.Generator(device=cuda).manual_seed(1)
    state = {"w": torch.randn(64, 32, device=cuda, generator=gen).to(torch.bfloat16),
             "m": torch.randn(64, 32, device=cuda, generator=gen),
             "count": torch.tensor(7, device=cuda), "rng": gen.get_state()}
    want = {k: v.clone() for k, v in state.items()}
    hosts = VirtualHosts(2)
    store = SnapshotStore(hosts, keep=2)
    try:
        store.reserve(state)
        assert store.begin(3, state, VirtualMesh((1, 8, 1), range(8)),
                           {"w": (None, "data"), "m": ("data", None)})
        state["w"].add_(1)
        state["m"].mul_(2)
        store.drain()
        for alive in ({0, 1}, {1}):
            got, used_mirror = store.restore(store.latest(), alive, device=cuda)
            assert used_mirror == (alive == {1})
            for k, v in want.items():
                assert got[k].dtype == v.dtype and got[k].device.type == "cuda"
                assert torch.equal(got[k].cpu(), v.cpu())
    finally:
        store.close()
