"""The port's copy of the page allocator and digest chain against the
reference's: the same operation sequence gives the same pages, refcounts,
index and errors."""

import numpy as np
import pytest

from arks_tpu.engine import paged as jpaged
from arks_tpu import prefix_sketch as jsketch
from arks_tpu_torch import prefix_sketch as tsketch
from arks_tpu_torch.engine import paged as tpaged


@pytest.mark.parametrize("page,n", [(4, 3), (16, 0), (16, 5)])
def test_chain_digests_match(page, n):
    ids = list(np.random.default_rng(page + n).integers(0, 1000, 70))
    assert tsketch.chain_digests(ids, page, n) == \
        jsketch.chain_digests(ids, page, n)
    assert list(tsketch.iter_chain_digests(ids, page)) == \
        list(jsketch.iter_chain_digests(ids, page))


@pytest.mark.parametrize("length,rows,page,maxp", [
    (0, 1, 16, 4), (15, 1, 16, 4), (16, 4, 16, 4), (60, 8, 16, 4),
    (255, 4, 256, 16)])
def test_pages_needed_matches(length, rows, page, maxp):
    assert tpaged.pages_needed(length, rows, page, maxp) == \
        jpaged.pages_needed(length, rows, page, maxp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_reference_on_random_ops(seed):
    rng = np.random.default_rng(seed)
    page = 4
    ref, port = jpaged.PageAllocator(12, page), tpaged.PageAllocator(12, page)
    held: list[list[int]] = []
    for step in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 4))
            outs = []
            for alloc in (ref, port):
                try:
                    outs.append(alloc.alloc(n))
                except Exception as e:  # both must raise alike
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
            if isinstance(outs[0], list):
                held.append(outs[0])
        elif op == 1 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            ref.decref(pages)
            port.decref(pages)
        elif op == 2 and held:
            pages = held[int(rng.integers(0, len(held)))]
            ids = list(rng.integers(0, 5, len(pages) * page))
            digests = jsketch.chain_digests(ids, page, len(pages))
            ref.register(digests, pages)
            port.register(digests, pages)
        elif op == 3:
            ids = list(rng.integers(0, 5, 3 * page))
            digests = jsketch.chain_digests(ids, page, 3)
            got = (ref.match(digests), port.match(digests))
            assert got[0] == got[1]
            if got[0]:
                held.append(got[0])
        assert (ref.free_pages, ref.retained_pages, ref._ref) == \
            (port.free_pages, port.retained_pages, port._ref)
