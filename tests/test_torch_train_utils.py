"""The training path's host-side pieces against the JAX package's: the
synthetic stream, the FLOP accounting, the memory budget under each
precision, the anomaly guard; and the prefetch
feeder and ``log.csv`` writer on their own. All exact: these are integer,
float64 or control-flow results with no device arithmetic in them."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from dtc_tpu.config import loader as jloader
from dtc_tpu.config import schema as jschema
from dtc_tpu.data.synthetic import synthetic_batch_iterator as jsynthetic
from dtc_tpu.resilience.guard import AnomalyGuard as JGuard
from dtc_tpu.utils.metrics import gpt_step_flops as jflops
from dtc_tpu.utils.metrics import train_memory_bytes as jtrain_memory_bytes
from dtc_tpu_torch.config import loader as tloader
from dtc_tpu_torch.config import schema as tschema
from dtc_tpu_torch.data.prefetch import PrefetchIterator
from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
from dtc_tpu_torch.resilience.guard import AnomalyGuard
from dtc_tpu_torch.utils.logging import CSVLogger
from dtc_tpu_torch.utils.metrics import gpt_step_flops, mfu, peak_flops, train_memory_bytes

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed,b,t,vocab", [(0, 8, 513, 50258), (3000, 2, 17, 97)])
def test_synthetic_batches_equal_jax(seed, b, t, vocab):
    got, want = synthetic_batch_iterator(b, t, vocab, seed), jsynthetic(b, t, vocab, seed)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["model_config.yaml", "model_config_dev.yaml"])
def test_step_flops_equal_jax(name):
    path = ROOT / "configs" / name
    tcfg = tloader.load_yaml_dataclass(path, tschema.ModelConfig)
    jcfg = jloader.load_yaml_dataclass(path, jschema.ModelConfig)
    for batch, seq in ((8, 512), (2, 64)):
        assert gpt_step_flops(tcfg, batch, seq) == jflops(jcfg, batch, seq)


@pytest.mark.parametrize("precision", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("train_name,parallel,mesh", [
    ("train_config_dp.yaml", "dp", {}),
    ("train_config_fsdp.yaml", "fsdp", {"pipe": 1, "data": 8, "model": 1}),
])
def test_train_memory_bytes_by_precision_equal_jax(precision, train_name, parallel, mesh):
    """The flagship's budget under each precision, one card and the FSDP
    mesh of ``train_config_fsdp.yaml`` over 8 devices: the JAX package's
    numbers, component by component; ``bf16_mixed`` holds 14 bytes a
    parameter of state against fp32's 12."""
    tcfg, mcfg, _ = tloader.load_config(ROOT / "configs" / train_name)
    _, jcfg, _ = jloader.load_config(ROOT / "configs" / train_name)
    want = jtrain_memory_bytes(jcfg, tcfg.batch, mcfg.max_seq_len, mesh, parallel,
                               precision=precision)
    got = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len, mesh, parallel,
                             precision=precision)
    assert got == want
    state = (got["params"] + got["master"] + got["moments"]) / (got["moments"] / 8)
    assert state == (14.0 if precision == "bf16_mixed" else 12.0)


def test_mfu_takes_the_peak_as_a_parameter():
    cfg = tloader.load_yaml_dataclass(ROOT / "configs" / "model_config.yaml", tschema.ModelConfig)
    flops = gpt_step_flops(cfg, 8, 512)
    assert mfu(cfg, 8, 512, 0.5, 1e15) == pytest.approx(flops / 5e14)
    assert mfu(cfg, 8, 512, 0.5, None) is None
    assert mfu(cfg, 8, 512, 0.0, 1e15) is None
    assert peak_flops("cpu") is None


def test_guard_decisions_equal_jax_without_checkpoints():
    """Window by window, the port's guard reports what the JAX guard
    decides when it has no checkpoint to roll back to."""
    kw = dict(spike_factor=2.0, spike_window=4)
    port, ref = AnomalyGuard(tschema.GuardConfig(**kw)), JGuard(jschema.GuardConfig(**kw),
                                                                 can_rollback=False)
    windows = [[5.0, 4.8], [4.6], [4.5, 4.4], [4.3], [9.5, 9.9], [4.2], [float("nan"), 4.1],
               [math.inf], [4.0], []]
    actions = []
    for step, losses in enumerate(windows):
        got, want = port.check_window(step, losses), ref.check_window(step, losses)
        assert (got.action, got.reason) == (want.action, want.reason)
        actions.append(got.action)
    assert actions.count("warn") == 3           # the spike and both non-finite windows


def _host_batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError("host stream broke")
        yield np.arange(i, i + 2 * 5).reshape(2, 5).astype(np.int32)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_splits_inputs_and_targets_in_order(depth):
    it = PrefetchIterator(_host_batches(4), torch.device("cpu"), depth=depth)
    got = list(it)
    it.close()
    it.close()
    assert len(got) == 4
    for i, (x, y) in enumerate(got):
        full = torch.arange(i, i + 10).reshape(2, 5)
        assert x.dtype == y.dtype == torch.int64
        assert torch.equal(x, full[:, :-1]) and torch.equal(y, full[:, 1:])


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_surfaces_the_host_error(depth):
    it = PrefetchIterator(_host_batches(4, fail_at=2), torch.device("cpu"), depth=depth)
    assert len([next(it), next(it)]) == 2
    with pytest.raises(KeyError, match="host stream broke"):
        next(it)
    it.close()


def test_csv_logger_schema_and_refusals(tmp_path):
    path = tmp_path / "sub" / "log.csv"
    log = CSVLogger(str(path))
    log.log(step=1, elapsed_time=0.5, loss=3.25)
    log.log(step=2, loss=3.0)
    with pytest.raises(ValueError, match="unknown field"):
        log.log(step=3, tokens=7)
    log.close()
    log.close()
    with pytest.raises(ValueError, match="closed"):
        log.log(step=4)
    assert path.read_text().splitlines() == ["step,elapsed_time,loss", "1,0.5,3.25", "2,,3.0"]
