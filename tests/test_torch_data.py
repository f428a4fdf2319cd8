"""The port's resumable data stream against the JAX package's, on the same
pre-tokenized documents (``tests/test_data.py``'s ``_docs``): the packer and
its position, the process stripes, the FineWeb stream and its seek, the
held-out split and its index maps, the self-healing retry wrapper and the
byte tokenizer. All byte-equal: integer arrays and control flow."""

import itertools
import json
import sys
import types

import numpy as np
import pytest

from dtc_tpu.data import fineweb as jfineweb
from dtc_tpu.data import holdout as jholdout
from dtc_tpu.data import packing as jpacking
from dtc_tpu.data import tokenizer as jtokenizer
from dtc_tpu.resilience import retry as jretry
from dtc_tpu_torch.data import fineweb, holdout, packing, tokenizer
from dtc_tpu_torch.resilience import retry
from dtc_tpu_torch.resilience.errors import DataStreamError
from tests.test_data import _docs, _TailOnlySeq


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("batch,seq,start", [(2, 3, 0), (3, 5, 4), (1, 16, 2)])
def test_token_packer_batches_and_positions_equal_jax(batch, seq, start):
    docs = _docs(60, tokens=7)
    buffer = [5, 6, 7]
    got = packing.TokenPacker(iter(docs[start:]), batch, seq, docs_consumed=start,
                              buffer=buffer)
    want = jpacking.TokenPacker(iter(docs[start:]), batch, seq, docs_consumed=start,
                                buffer=buffer)
    for _ in range(5):
        _same([next(got)], [next(want)])
        assert got.position() == want.position()
        json.dumps(got.position())  # a sidecar holds it


@pytest.mark.parametrize("count", [1, 3])
def test_stride_documents_equal_jax(count):
    docs = _docs(31)
    for p in range(count):
        for start in (0, 6):
            got = list(fineweb.stride_documents(iter(docs[start:]), p, count, start))
            assert got == list(jfineweb.stride_documents(iter(docs[start:]), p, count, start))
    whole = sorted(itertools.chain.from_iterable(
        fineweb.stride_documents(iter(range(31)), p, count) for p in range(count)))
    assert whole == list(range(31))


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 3)])
def test_fineweb_stream_and_its_seek_equal_jax(process_index, process_count):
    """The stream's batches equal JAX's, and a stream built from
    ``position_after(k)`` (over a source that refuses the documents already
    read) continues with the uninterrupted stream's batch k+1."""
    docs = _docs(400, tokens=9)
    kw = dict(process_index=process_index, process_count=process_count)
    got = fineweb.FinewebStream(2, 5, documents=docs, **kw)
    want = jfineweb.FinewebStream(2, 5, documents=docs, **kw)
    first = [next(got) for _ in range(7)]
    _same(first, [next(want) for _ in range(7)])
    for k in (1, 4):
        pos = got.position_after(k)
        assert pos == want.position_after(k)
        tail = _TailOnlySeq(docs, pos["docs_consumed"] * process_count)
        resumed = fineweb.FinewebStream(2, 5, documents=tail, position=pos, **kw)
        _same([next(resumed) for _ in range(7 - k)], first[k:])
    with pytest.raises(KeyError, match="history"):
        fineweb.FinewebStream(2, 5, documents=docs, history=2, **kw).position_after(1)


def _no_gpt2(monkeypatch):
    """No GPT-2 tokenizer to load (as without a cached copy), whatever the
    machine's cache holds: ``transformers`` stands in as a module whose
    ``AutoTokenizer.from_pretrained`` raises."""
    class AutoTokenizer:
        @staticmethod
        def from_pretrained(*a, **k):
            raise OSError("no cached gpt2")

    stub = types.ModuleType("transformers")
    stub.AutoTokenizer = AutoTokenizer
    monkeypatch.setitem(sys.modules, "transformers", stub)
    monkeypatch.delenv("DTC_ALLOW_BYTE_FALLBACK", raising=False)


def test_fineweb_stream_without_documents_fails_at_the_tokenizer(monkeypatch):
    """No injected documents and no GPT-2 tokenizer: both streams raise the
    tokenizer's RuntimeError before any document is read."""
    _no_gpt2(monkeypatch)
    for mod in (fineweb, jfineweb):
        with pytest.raises(RuntimeError, match="DTC_ALLOW_BYTE_FALLBACK"):
            mod.FinewebStream(2, 5)


@pytest.mark.parametrize("every,count", [(3, 4), (1, 2), (4, 1)])
def test_holdout_split_and_index_maps_equal_jax(every, count):
    docs = _docs(300)
    train_it, eval_set = holdout.divert_holdout(fineweb.FinewebStream(2, 4, documents=docs),
                                                every, count)
    jtrain_it, jeval_set = jholdout.divert_holdout(
        jfineweb.FinewebStream(2, 4, documents=docs), every, count)
    _same(eval_set, jeval_set)
    _same([next(train_it) for _ in range(10)], [next(jtrain_it) for _ in range(10)])
    div = holdout.diverted_indices(every, count)
    assert div == jholdout.diverted_indices(every, count)
    for n in (1, 2, 3, 5, 40):
        assert holdout.holdout_stream_index(n, every, count) == \
            jholdout.holdout_stream_index(n, every, count)
        assert holdout.stream_index_for(n, {2, 7}) == jholdout.stream_index_for(n, {2, 7})
        assert holdout.stream_index_for(n, set()) == n


def _flaky(docs, fail_at, opens, exc=ConnectionError):
    armed = {"on": True}

    def factory(index):
        opens.append(index)

        def gen():
            for off, v in enumerate(docs[index:]):
                if armed["on"] and index + off == fail_at:
                    armed["on"] = False
                    raise exc("flaky shard")
                yield v
        return gen()
    return factory


@pytest.mark.parametrize("fail_at", [0, 7, 19])
def test_resilient_iterator_heals_at_the_exact_position_as_jax(fail_at):
    docs = list(range(20))
    kw = dict(backoff_s=0.0, jitter=0.0, sleep=lambda s: None)
    opens, jopens, events = [], [], []
    got = list(retry.resilient_iterator(_flaky(docs, fail_at, opens),
                                        on_event=lambda *a, **k: events.append(k), **kw))
    want = list(jretry.resilient_iterator(_flaky(docs, fail_at, jopens), **kw))
    assert got == want == docs
    assert opens == jopens == [0, fail_at]
    assert [e["index"] for e in events] == [fail_at]


def test_resilient_iterator_exhausts_to_the_typed_error_and_cancels():
    import threading

    def down(index):
        raise ConnectionError("network down")

    sleeps = []
    it = retry.resilient_iterator(down, max_attempts=3, backoff_s=1.0, jitter=0.0,
                                  sleep=sleeps.append)
    with pytest.raises(DataStreamError, match="3 consecutive attempts") as ei:
        next(it)
    assert isinstance(ei.value.__cause__, ConnectionError) and sleeps == [1.0, 2.0]
    cancel = threading.Event()
    cancel.set()
    assert list(retry.resilient_iterator(down, backoff_s=3600.0, cancel=cancel)) == []


def test_fineweb_stream_heals_a_transient_fault_offline():
    """A sequence of documents is re-openable: a fault inside it is healed
    by the retry wrapper, which re-opens the source at the failing
    document, and the batches equal an unfaulted stream's."""
    from dtc_tpu_torch.config.schema import StreamRetryConfig

    docs = _docs(200)
    opens = []

    class Flaky:
        armed = True

        def __getitem__(self, sl):
            opens.append(sl.start)

            def gen():
                for off, d in enumerate(docs[sl]):
                    if Flaky.armed and sl.start + off == 10:
                        Flaky.armed = False
                        raise ConnectionError("shard reset")
                    yield d
            return gen()

    cfg = StreamRetryConfig(backoff_s=0.0, jitter=0.0)
    got = fineweb.FinewebStream(2, 4, documents=Flaky(), retry=cfg)
    want = fineweb.FinewebStream(2, 4, documents=docs)
    _same([next(got) for _ in range(20)], [next(want) for _ in range(20)])
    assert opens == [0, 10]


@pytest.mark.parametrize("text", ["hello world", "grüße, ☃", ""])
def test_byte_tokenizer_equals_jax(text):
    got, want = tokenizer.ByteTokenizer(), jtokenizer.ByteTokenizer()
    assert len(got) == len(want) == tokenizer.GPT2_PADDED_VOCAB == jtokenizer.GPT2_PADDED_VOCAB
    ids = got.encode(text)
    assert ids == want.encode(text)
    assert got.decode(ids) == want.decode(ids) == text
    assert got.decode(ids + [300]) == want.decode(ids + [300])


def test_get_tokenizer_refuses_the_byte_fallback_unless_asked(monkeypatch):
    """Without a loadable GPT-2 tokenizer both raise the same RuntimeError;
    asked for, both give the byte tokenizer."""
    _no_gpt2(monkeypatch)
    for mod in (tokenizer, jtokenizer):
        with pytest.raises(RuntimeError, match="DTC_ALLOW_BYTE_FALLBACK"):
            mod.get_tokenizer(allow_download=False)
    got = tokenizer.get_tokenizer(allow_download=False, allow_byte_fallback=True)
    assert isinstance(got, tokenizer.ByteTokenizer)
