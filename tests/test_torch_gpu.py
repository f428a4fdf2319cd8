"""The port on a CUDA card: the decode-attention and flash-attention
kernels against their plain versions, and the kernels on the model's
decode and training paths. Needs an NVIDIA GPU with ``nvcc``; elsewhere
every test skips with the reason.

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: outputs ``parity.attention_tolerance``
(float32 1e-5, summation order; bfloat16 and int8-dequantized-to-bfloat16
a few bf16 ulps of each head's largest output), gradients
``parity.grad_tolerance`` (float32 1e-5 × the largest |value|; bfloat16 a
few ulps of each head's largest value).
"""

import pytest
import torch

from dtc_tpu_torch.config.schema import ModelConfig
from dtc_tpu_torch.ops import decode_attention as da
from dtc_tpu_torch.parity import attention_tolerance

pytestmark = pytest.mark.gpu


def _assert_close(got, want, h):
    limit = attention_tolerance(want, h).to(got.device)
    assert ((got.float() - want.float()).abs() <= limit).all()


@pytest.fixture
def cuda():
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


def test_kernel_long_cache_walks_chunks(cuda):
    """Past 4096 positions the kernel's online softmax spans chunks."""
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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2, 64, 100, 512])
def test_flash_kernels_match_plain(cuda, t, dt, d):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against their
    plain versions, at tile-aligned and ragged T."""
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import grad_tolerance

    h = 2
    q, k, v, do = _flash_case(cuda, 2, t, h, d, dt)
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
        assert ((g_.float() - w_.float()).abs() <= grad_tolerance(w_, h).to(cuda)).all()


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
    x = torch.zeros(2, 300, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a head_dim the kernels have no instance for
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
