"""The traffic generator: deterministic per seed, the same work for every
seed, and the distributions the mix files state."""

import statistics

import pytest

from portbench import harness, loadgen

RAG = harness.load_json(f"{harness.PB}/traffic/rag.json")
LONGDOC = harness.load_json(f"{harness.PB}/traffic/longdoc.json")
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", [RAG, LONGDOC], ids=["rag", "longdoc"])
def test_same_seed_same_requests(mix):
    a = loadgen.Traffic(mix, SEED, 32000)
    b = loadgen.Traffic(mix, SEED, 32000)
    for c in (0, mix["clients"] - 1):
        for r in (0, 5):
            x, y = a.request(c, r), b.request(c, r)
            assert x.prompt == y.prompt and x.max_tokens == y.max_tokens
    assert a.request(0, 0).prompt != loadgen.Traffic(
        mix, SEED + 1, 32000).request(0, 0).prompt


@pytest.mark.parametrize("mix", [RAG, LONGDOC], ids=["rag", "longdoc"])
def test_every_seed_gives_the_same_sizes_each_round(mix):
    def sizes(seed, r):
        t = loadgen.Traffic(mix, seed, 32000)
        reqs = [t.request(c, r) for c in range(mix["clients"])]
        return (sorted(len(q.prompt) for q in reqs),
                sorted(q.max_tokens for q in reqs))
    for r in (0, 3):
        assert sizes(1, r) == sizes(SEED, r)


def test_rag_lengths_follow_the_mix():
    p = loadgen.quantiles(RAG["prompt"], 1000)
    assert min(p) == 512 and max(p) == 4096
    assert abs(statistics.median(p) - 1536) <= 2
    o = loadgen.quantiles(RAG["output"], 1000)
    assert min(o) == 16 and max(o) == 64
    assert abs(statistics.mean(o) - 40) < 0.5


def test_longdoc_documents_and_questions():
    t = loadgen.Traffic(LONGDOC, SEED, 32000)
    docs = [len(d) for d in t.docs]
    assert len(docs) == 24 and min(docs) >= 8192 and max(docs) <= 16384
    assert abs(statistics.mean(docs) - 12288) < 200
    q = t.request(3, 2)
    assert q.prompt[:q.doc_len] == t.docs[3]
    assert 32 <= len(q.prompt) - q.doc_len <= 128
    assert 64 <= q.max_tokens <= 256
    assert loadgen.max_context(LONGDOC) == 16384 + 128 + 256


def test_token_ids_in_vocabulary():
    t = loadgen.Traffic(RAG, SEED, 1000)
    ids = t.request(1, 1).prompt
    assert min(ids) >= 0 and max(ids) < 1000
