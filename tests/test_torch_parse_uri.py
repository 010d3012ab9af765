"""parse_url of the PyTorch/CUDA port against the JAX package on the same
inputs (on the CPU), byte-equal for all eight parts and QUERY with a key:
the reference's curated table (java.net.URI behaviour), composed URLs,
and byte edits of both (forbidden characters, bad '%' escapes, broken
IPv6 hosts).
"""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar import Column as RefColumn
from spark_rapids_jni_tpu.ops.parse_uri import parse_url as ref_parse_url

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.ops.parse_uri import parse_url

CPU = torch.device("cpu")
PARTS = ("PROTOCOL", "HOST", "PATH", "QUERY", "REF", "AUTHORITY", "FILE",
         "USERINFO")
CURATED = [
    "https://user:pw@www.Example.com:8080/a/b.html?x=1&y=2#frag",
    "http://h/p?max=9&x=1", "http://h/p?a=&a=2",
    "http://spark.apache.org/path", "http://h", "/rel/path",
    "mailto:someone@example.com", "not a url", "http://h ost/",
    "http://host/%zz", "http://ho<st/", "http://host:8a0/",
    "http://h/p%20x", "mailto:a@b?subject=hi", "http://[::1/x",
    "http://[::1]junk:80/", "http://[::1]:x/",
    "https://[2001:db8::1]:443/x", "http://host:8080/x", "x", "", None,
    "?a=1#f", "#r", "s3a://bucket/key?versionId=3", "ftp://u@h:21",
    "http://a@b@c/d", "1http://x/", "h+t.t-p://x/y", "http://h/%4", "//h/p",
    "http://h?x=1", "http://h#", "http://[v1.x]/", "HTTP://H:/p?#"]


def _composed(rng, n):
    schemes = ["http", "https", "ftp", "s3a", "file"]
    hosts = ["example.com", "a.b-c.d", "h0st", "[::1]", "10.0.0.1",
             "[2001:db8::7]", "x_y~z"]
    paths = ["", "/", "/a/b", "/x.y/z_w", "/%41b"]
    queries = [None, "k=v", "a=1&bb=22&c=", "x=1&y=2&k=3&x=4&z=5&q=6"]
    users = [None, "alice", "u:p"]
    ports = [None, "80", "8443"]
    refs = [None, "top", "sec-2"]
    out = []
    for _ in range(n):
        pick = [c[int(rng.integers(len(c)))] for c in (
            schemes, hosts, paths, queries, refs, users, ports)]
        sc, ho, pa, qu, re_, us, po = pick
        auth = (us + "@" if us else "") + ho + (":" + po if po else "")
        out.append(f"{sc}://{auth}{pa}" + (f"?{qu}" if qu else "")
                   + (f"#{re_}" if re_ else ""))
    return out


def _mutated(rng, base, n):
    alphabet = list("abcxyz019:/?#@&=%[].-_~ +<\"|")
    out = []
    for _ in range(n):
        s = list(str(rng.choice(base)))
        for _ in range(int(rng.integers(0, 4))):
            k = int(rng.integers(0, len(s) + 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                s.insert(k, str(rng.choice(alphabet)))
            elif s and op == 1:
                s.pop(min(k, len(s) - 1))
            elif s:
                s[min(k, len(s) - 1)] = str(rng.choice(alphabet))
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def urls():
    rng = np.random.default_rng(31)
    composed = _composed(rng, 600)
    strs = CURATED + composed + _mutated(rng, CURATED[:21] + composed[:50],
                                         1400)
    return strs, RefColumn.strings_from_list(strs), \
        Column.strings_from_list(strs, device=CPU)


@pytest.mark.parametrize("part", PARTS)
def test_parse_url_matches_reference(urls, part):
    _, ref, col = urls
    assert parse_url(col, part).to_pylist() == \
        ref_parse_url(ref, part).to_pylist()


@pytest.mark.parametrize("key", ["x", "a", "versionId", "k", "q", "bb"])
def test_parse_url_query_key_matches_reference(urls, key):
    _, ref, col = urls
    got = parse_url(col, "QUERY", key).to_pylist()
    assert got == ref_parse_url(ref, "QUERY", key).to_pylist()
    assert any(v is not None for v in got)


def test_parse_url_curated_parts():
    col = Column.strings_from_list(CURATED[:1], device=CPU)
    assert [parse_url(col, p).to_pylist()[0] for p in PARTS] == [
        "https", "www.Example.com", "/a/b.html", "x=1&y=2", "frag",
        "user:pw@www.Example.com:8080", "/a/b.html?x=1&y=2", "user:pw"]
    with pytest.raises(Exception):
        parse_url(col, "NOPE")
    with pytest.raises(Exception):
        parse_url(col, "HOST", "x")
