"""The port on a CUDA card: the decode-attention kernel against its plain
version, and the kernel on the model's decode path. Needs an NVIDIA GPU
with ``nvcc``; elsewhere every test skips with the reason.

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py (``parity.attention_tolerance``): float32
1e-5 (summation order); bfloat16 and int8-dequantized-to-bfloat16 a few
bf16 ulps of each head's largest output.
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
