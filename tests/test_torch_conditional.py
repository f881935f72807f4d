"""The port's conditional-paint helpers (``headlamp_tpu_torch/push/conditional.py``)
against the JAX package's (``headlamp_tpu/push/conditional.py``), on the
CPU: ``etag_for``, ``window_token``, ``if_none_match_matches``,
``gzip_accepted`` and ``encode_body`` give equal outputs on the same
inputs, exactly (the gzip bytes too: ``mtime=0`` makes them
deterministic), and the ETag-keyed output cache hits, misses and evicts
as JAX's does, counted in the port's own families.
"""

from __future__ import annotations

import gzip
import itertools

import numpy as np

from headlamp_tpu.push import conditional as jc
from headlamp_tpu_torch.obs.metrics import registry as tregistry
from headlamp_tpu_torch.push import conditional as tc

PATHS = (
    "/tpu", "/tpu/", "/tpu/nodes?page=2", "/tpu/nodes?limit=10&cursor=abc",
    "/tpu/nodes?cursor=abc&limit=10", "/tpu/fleet?region=cluster/0/slice/3&limit=64",
    "/tpu/metrics?", "/tpu/pods?q=&limit=5", "/tpu?a=1&a=2", "/tpu/nodes?q=%20x%2Fy",
)
HEADERS = (
    None, "", "*", ' "g1-e0-d0" ', 'W/"g1-e0-d0"', '"other", W/"g1-e0-d0"', '"g1-e0-d1"',
    '"g1-e0-d0-wdeadbeef"', "W/*",
)
ENCODINGS = (
    None, "", "gzip", "GZIP", "gzip;q=0", "gzip; q=0.5", "br, gzip;q=0.1", "*", "*;q=0",
    "identity", "deflate, *;q=0.3", "gzip;q=abc", "br;q=1, gzip;q=0",
)


def test_etags_and_window_tokens_are_equal():
    for generation, epoch, degraded in itertools.product((0, 1, 7, 2**40), (0, 3), (False, True)):
        for path in PATHS:
            window = tc.window_token(path)
            assert window == jc.window_token(path), path
            assert tc.etag_for(generation, epoch, degraded, window=window) == jc.etag_for(
                generation, epoch, degraded, window=window
            )
    assert tc.window_token("/tpu/nodes?a=1&b=2") == tc.window_token("/tpu/nodes?b=2&a=1")
    assert tc.window_token("/tpu") == "" and tc.etag_for(4, 1, True) == '"g4-e1-d1"'


def test_if_none_match_and_gzip_negotiation_are_equal():
    for header, etag in itertools.product(HEADERS, ('"g1-e0-d0"', '"g1-e0-d0-wdeadbeef"')):
        assert tc.if_none_match_matches(header, etag) == jc.if_none_match_matches(header, etag)
    assert tc.if_none_match_matches('W/"g1-e0-d0"', '"g1-e0-d0"')
    for accept in ENCODINGS:
        assert tc.gzip_accepted(accept) == jc.gzip_accepted(accept), accept


def test_encode_body_gives_the_same_bytes():
    rng = np.random.default_rng(0)
    bodies = [
        b"",
        b"<main>short</main>",
        ("<tr><td>gke-node</td><td>75.0%</td></tr>" * 400).encode(),
        rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),  # incompressible
    ]
    for body, accept in itertools.product(bodies, ENCODINGS):
        got, want = tc.encode_body(body, accept), jc.encode_body(body, accept)
        assert got == want, (len(body), accept)
        if got[1] == "gzip":
            assert gzip.decompress(got[0]) == body


def test_the_gzip_cache_hits_misses_and_evicts_as_jax():
    family = "headlamp_tpu_torch_push_gzip_cache_total"
    cache = next(m for m in tregistry if m.name == family)

    def count(outcome):
        return cache.value_for(outcome=outcome)

    tc.gzip_cache_clear()
    jc.gzip_cache_clear()
    before = {o: count(o) for o in ("hit", "miss", "evicted")}
    body = ("<p>paint</p>" * 200).encode()
    trail = []
    for i in range(tc.GZIP_CACHE_LIMIT + 3):
        for _ in range(2):  # a miss, then a hit
            etag = f'"g{i}-e0-d0"'
            got = tc.encode_body(body, "gzip", etag=etag)
            assert got == jc.encode_body(body, "gzip", etag=etag)
        trail.append((tc.gzip_cache_len(), jc.gzip_cache_len()))
    assert all(a == b for a, b in trail)
    assert trail[-1] == (tc.GZIP_CACHE_LIMIT, jc.GZIP_CACHE_LIMIT)
    moved = {o: count(o) - before[o] for o in before}
    assert moved == {"hit": tc.GZIP_CACHE_LIMIT + 3, "miss": tc.GZIP_CACHE_LIMIT + 3, "evicted": 3}
    tc.gzip_cache_clear()
    jc.gzip_cache_clear()
    assert tc.gzip_cache_len() == 0
