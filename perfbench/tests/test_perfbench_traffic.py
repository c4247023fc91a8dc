"""The chat mixes: deterministic per seed, clipped, the same work for every
seed in another order, the width classes the server will see."""
import numpy as np
import pytest

from perfbench.lib.spec import ROOT, load_json
from perfbench.traffic.generator import (LMBatches, ServeMix, exponential_gaps,
                                         lognormal_quantiles, prompt_width)

MIXES = ["chat-backlog", "chat-paced"]
VOCAB = 50304


def mix(name):
    return load_json(ROOT / "perfbench" / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = ServeMix(mix(name), VOCAB, 2**31 + 7), ServeMix(mix(name), VOCAB, 2**31 + 7)
    for i in (0, 1, 63, 64, 200):
        (pa, ba), (pb, bb) = a.request(i), b.request(i)
        assert ba == bb and np.array_equal(pa, pb)
        assert a.arrival(i) == b.arrival(i)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_replays_the_same_schedule_with_its_own_ids(name):
    m = mix(name)
    gens = [ServeMix(m, VOCAB, seed) for seed in (1, 2**31 + 9, 2**33 + 5)]
    for i in range(2 * m["block"]):
        reqs = [g.request(i) for g in gens]
        assert len({(len(p), b) for p, b in reqs}) == 1
        assert len({g.arrival(i) for g in gens}) == 1
        assert not np.array_equal(reqs[0][0], reqs[1][0])


@pytest.mark.parametrize("name", MIXES)
def test_each_block_holds_the_same_lengths_in_another_order(name):
    m = mix(name)
    g = ServeMix(m, VOCAB, 1)
    blocks = [[g.request(b * m["block"] + i) for i in range(m["block"])] for b in range(2)]
    lens = [[(len(p), o) for p, o in blk] for blk in blocks]
    assert sorted(p for p, _ in lens[0]) == sorted(p for p, _ in lens[1])
    assert sorted(o for _, o in lens[0]) == sorted(o for _, o in lens[1])
    assert lens[0] != lens[1]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_and_ids_within_their_clip(name):
    m = mix(name)
    g = ServeMix(m, VOCAB, 3)
    for i in range(3 * m["block"]):
        p, b = g.request(i)
        assert m["prompt"]["min"] <= len(p) <= m["prompt"]["max"]
        assert m["output"]["min"] <= b <= m["output"]["max"]
        assert p.min() >= m["token_low"] and p.max() < VOCAB


def test_quantiles_median_and_clip():
    q = lognormal_quantiles({"median": 512, "sigma": 0.8, "min": 32, "max": 1024}, 64)
    assert q.min() >= 32 and q.max() == 1024 and int(np.median(q)) in range(490, 535)
    assert len(q) == 64 and list(q) == sorted(q)


def test_width_classes_are_the_six_prefill_widths():
    g = ServeMix(mix("chat-backlog"), VOCAB, 1)
    assert g.widths(2048) == [32, 64, 128, 256, 512, 1024]
    assert [prompt_width(n, 2048) for n in (32, 33, 512, 513, 1024)] == [32, 64, 512, 1024, 1024]
    assert prompt_width(1500, 2048) == 1024 and prompt_width(1, 2048) == 2


def test_paced_arrivals_keep_the_rate_per_block():
    m = mix("chat-paced")
    g = ServeMix(m, VOCAB, 5)
    n = m["block"]
    assert g.arrival(n - 1) == pytest.approx(n / m["rate_per_s"], rel=1e-9)
    assert np.all(np.diff([g.arrival(i) for i in range(2 * n)]) > 0)
    assert exponential_gaps(2.0, 64).mean() == pytest.approx(0.5)


def test_closed_mix_has_clients_and_no_schedule():
    m = mix("chat-backlog")
    assert m["loop"] == "closed" and m["clients"] == 128


def test_train_batches_per_seed_and_step():
    m = load_json(ROOT / "perfbench" / "traffic" / "train-8x2048.json")
    m = dict(m, batch=3, seq=16)
    a, b = LMBatches(m, 100, 11), LMBatches(m, 100, 11)
    x, y = a.batch_at(2, "cpu"), b.batch_at(2, "cpu")
    assert (x["tokens"] == y["tokens"]).all() and (x["labels"] == y["labels"]).all()
    assert (x["tokens"][:, 1:] == x["labels"][:, :-1]).all()
    assert not (a.batch_at(3, "cpu")["tokens"] == x["tokens"]).all()
    assert len({tuple(r.tolist()) for r in x["tokens"]}) == 3
