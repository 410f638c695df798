"""The port's C++ parser, its sort meta and its transfer stage on the CPU.

``fast_tffm_tpu_torch.data.native`` (its own copy of the C++ source,
built with g++ into ``data/_build/``) against the reference's
``fast_tffm_tpu.data.native`` and against the port's Python parser
(``libsvm.parse_line`` + ``make_batch``), bitwise: labels, ids, vals,
fields, weights and truncation counts, on the cases of the reference's
``tests/test_native_parser.py``; ``murmur64`` and ``find_line_offsets``;
the C++ sort meta against ``host_sort_meta`` and the reference's
``sort_meta`` permutation.  Then ``data.prefetch``: the transfer stage's
device views against ``stack_batches`` of the same group (on the CPU
the "device" buffer is the staging buffer itself).
"""

import threading

import numpy as np
import pytest
import torch

from fast_tffm_tpu.data import libsvm as ref_libsvm
from fast_tffm_tpu.data import native as ref_native
from fast_tffm_tpu_torch.data import libsvm, native
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.data.pipeline import EpochEnd
from fast_tffm_tpu_torch.data.prefetch import (
    DevicePrefetcher, layout, stack_batches,
)

LEAVES = ("labels", "ids", "vals", "fields", "weights")


def _assert_batches_equal(got, want):
    for name in LEAVES:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _python_batch(lines, batch_size, max_features, vocab, hash_ids=False,
                  field_num=0, weights=None):
    """The Python parser's batch, blank and ``#`` lines kept as weight-0
    rows (the native parser's row convention)."""
    exs = [libsvm.parse_line(t, vocab, hash_ids, field_num) for t in lines]
    w = [0.0 if ex is None else (1.0 if weights is None else weights[i])
         for i, ex in enumerate(exs)]
    return libsvm.make_batch(exs, batch_size, max_features, w)


def _three_ways(lines, batch_size, max_features, vocab, hash_ids=False,
                field_num=0, weights=None, num_threads=1):
    """Port native, reference native and Python parser on ``lines``; the
    port's batch and its truncation count."""
    kw = dict(hash_feature_id=hash_ids, field_num=field_num,
              num_threads=num_threads)
    port = native.NativeParser(vocab, max_features, **kw)
    got = port.parse_batch(lines, batch_size, weights)
    want = ref_native.NativeParser(vocab, max_features, **kw).parse_batch(
        lines, batch_size, weights)
    _assert_batches_equal(got, want)
    _assert_batches_equal(got, _python_batch(
        lines, batch_size, max_features, vocab, hash_ids, field_num, weights))
    return got, port.truncated_features


def _random_lines(rng, n, vocab, ffm=False, hash_ids=False):
    lines = []
    for _ in range(n):
        label = rng.choice(["1", "0", "-1"])
        toks = []
        for _ in range(int(rng.integers(1, 12))):
            fid = (f"feat_{rng.integers(0, 10**9)}" if hash_ids
                   else str(rng.integers(0, vocab * 2)))
            val = f"{rng.uniform(-2, 2):.4f}"
            if ffm:
                toks.append(f"{rng.integers(0, 99)}:{fid}:{val}")
            elif rng.uniform() < 0.1:
                toks.append(fid)
            else:
                toks.append(f"{fid}:{val}")
        lines.append(f"{label} {' '.join(toks)}")
    return lines


def test_murmur64_matches_the_reference_and_python():
    for token in [b"", b"a", b"abcdefg", b"abcdefgh", b"abcdefghi",
                  b"userid_12345", "féature".encode("utf-8"), b"x" * 1000]:
        want = ref_native.murmur64_native(token)
        assert native.murmur64_native(token) == want == libsvm.murmur64(
            token), token


@pytest.mark.parametrize("text", [
    b"", b"\n", b"1 2:3\n", b"1 2:3", b"a\n\nb\n", b"\n\n#c\nx y\nz",
    b"0 1:1\n" * 300,
])
def test_find_line_offsets_match_the_reference(text):
    got = native.find_line_offsets(text)
    np.testing.assert_array_equal(got, ref_native.find_line_offsets(text))
    assert got.dtype == np.int64
    # A length cuts the scan, a small guess grows the output.
    cut = len(text) // 2
    np.testing.assert_array_equal(native.find_line_offsets(text, cut, 1),
                                  ref_native.find_line_offsets(text, cut, 1))


@pytest.mark.parametrize("ffm, hash_ids", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_parse_batch_matches_the_reference_and_python(ffm, hash_ids):
    rng = np.random.default_rng(3)
    lines = _random_lines(rng, 64, 1000, ffm, hash_ids)
    got, trunc = _three_ways(lines, 64, 8, 1000, hash_ids,
                             field_num=7 if ffm else 0, num_threads=4)
    assert trunc > 0  # up to 11 features into 8 slots
    if ffm:
        assert got.fields.max() > 0


def test_adversarial_tokens_accepted_and_rejected_alike():
    """The reference's fuzz: every parser accepts and rejects the same
    lines, and agrees bitwise on what it accepts."""
    frags = [
        "1", "0", "-1", "2.5", ".5", "+.5", "-0.25", "1e5", "1E-3", "nan",
        "inf", "-inf", "infinity", "0x1p3", "1_000", "00123", "", "abc",
        "1.2.3", "1..2", "+", "-", ":", "::", "1:", ":1", "1:2:3:4", "%",
        "123456789012345678901234567890", "1:+2", "1:-2e-2", "1:nan",
        "1:0x10", "1:1_0", "007:1", "1.", "5:.5", "3:1e", "2:1.5e+2",
        "1:16777217.0000000000000001", "1:0.10000000000000000555",
        "2:33554433.0000000000000001",
    ]
    rng = np.random.default_rng(42)
    port = native.NativeParser(1000, 8)
    ref = ref_native.NativeParser(1000, 8, num_threads=1)
    for _ in range(1500):
        line = " ".join(rng.choice(frags)
                        for _ in range(int(rng.integers(1, 5))))
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        outs = []
        for parse in (lambda: port.parse_batch([line], 1),
                      lambda: ref.parse_batch([line], 1),
                      lambda: _python_batch([line], 1, 8, 1000)):
            try:
                outs.append(parse())
            except ValueError:
                outs.append(None)
        assert len({o is None for o in outs}) == 1, line
        if outs[0] is not None:
            _assert_batches_equal(outs[0], outs[1])
            _assert_batches_equal(outs[0], outs[2])


def test_blank_and_comment_lines_are_weight_zero_rows():
    got, _ = _three_ways(["1 5:1.0", "", "# note", "0 7:2.0", "   "], 6, 4,
                         100)
    np.testing.assert_array_equal(got.weights, [1, 0, 0, 1, 0, 0])
    assert got.ids[0, 0] == 5 and got.ids[3, 0] == 7


def test_truncation_and_weights():
    _, trunc = _three_ways(["1 1:1 2:1 3:1 4:1", "0 1:1"], 2, 2, 100)
    assert trunc == 2
    got, _ = _three_ways(["1 1:1", "0 2:1"], 4, 4, 100, weights=[0.5, 2.0])
    np.testing.assert_array_equal(got.weights, [0.5, 2.0, 0, 0])


@pytest.mark.parametrize("bad", [
    "1 a:b:c:d", "notalabel 1:1", "1x 1:1", "1 :2", "1 3:", "1 :5:0.5",
    "1 1:1 2:1 3:1 bad:",  # past max_features: still malformed
])
def test_malformed_lines_raise_naming_their_row(bad):
    parser = native.NativeParser(100, 2)
    with pytest.raises(native.MalformedLineError,
                       match="batch line 1") as exc:
        parser.parse_batch(["1 1:1", bad], 2)
    assert exc.value.index == 1 and isinstance(exc.value, ValueError)
    for reject in (lambda: ref_native.NativeParser(100, 2).parse_batch(
                       ["1 1:1", bad], 2),
                   lambda: _python_batch(["1 1:1", bad], 2, 2, 100)):
        with pytest.raises(ValueError):
            reject()


def test_long_negative_and_zero_padded_ids_match_python_ints():
    pad = "0" * 25
    _three_ways(["1 9223372036854775806:1.0",
                 "1 99999999999999999999999999:1.0", "1 -7:1.0",
                 "0 -99999999999999999999999:2"], 4, 4, 1000)
    _three_ways([f"{pad}1 {pad}42:1.5", f"1 {pad}7:{pad}2:1.0",
                 f"0 {'0' * 30}:1.0"], 3, 4, 1000, field_num=3)


def test_empty_hashed_id_and_vocabulary_bounds():
    _three_ways(["1 :2.0"], 1, 4, 100, hash_ids=True)
    with pytest.raises(ValueError, match="out of range"):
        native.NativeParser(1 << 60, 4)


def test_multithreaded_large_batch():
    lines = _random_lines(np.random.default_rng(5), 2048, 5000)
    _three_ways(lines, 2048, 16, 5000, num_threads=8)


def test_parse_raw_takes_permuted_extents():
    """A window with blank, whitespace and ``#`` lines and no final
    newline, parsed in a permuted order at its ``find_line_offsets``
    extents: the reference's parse_raw and the Python parser agree."""
    rng = np.random.default_rng(8)
    lines = _random_lines(rng, 40, 500)
    for pos, text in ((3, ""), (9, "# c"), (17, "   "), (30, " # x")):
        lines[pos] = text
    buf = "\n".join(lines).encode()
    starts = native.find_line_offsets(buf)
    ends = np.append(starts[1:], len(buf))
    perm = rng.permutation(len(starts))
    s, e = starts[perm][:32], ends[perm][:32]
    port = native.NativeParser(500, 6)
    got = port.parse_raw(buf, s, e, 40)
    ref = ref_native.NativeParser(500, 6, num_threads=1)
    _assert_batches_equal(got, ref.parse_raw(buf, s, e, 40))
    texts = [buf[a:b].decode() for a, b in zip(s, e)]
    _assert_batches_equal(got, _python_batch(texts, 40, 6, 500))
    assert port.truncated_features == ref.truncated_features > 0
    assert int((got.weights == 0).sum()) == 8 + sum(
        1 for t in texts if not t.strip() or t.lstrip().startswith("#"))
    bad = buf + b"\n0 4:zz"
    s2 = np.append(s[:3], len(buf) + 1)
    e2 = np.append(e[:3], len(bad))
    with pytest.raises(native.MalformedLineError, match="4:zz") as exc:
        port.parse_raw(bad, s2, e2, 4)
    assert exc.value.index == 3


@pytest.mark.parametrize("vocab, n, dup", [
    (64, 1000, 0.0),          # one id value a bucket: no low-bit pass
    (1 << 22, 159744, 0.3),   # Criteo-Kaggle: one 11-bit pass
    (1 << 30, 5000, 0.5),     # two low-bit passes
    (1000, 1, 0.0), (1000, 0, 0.0),
])
def test_sort_meta_is_host_sort_meta_bitwise(vocab, n, dup):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    if n:
        ids[rng.random(n) < dup] = ids[0]  # a hot id
    got = native.sort_meta(ids, vocab)
    want = libsvm.host_sort_meta(ids)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if n and vocab % 256 == 0:
        ref = ref_native.sort_meta(ids, vocab, 512, 256)
        np.testing.assert_array_equal(got.perm, ref.perm[:n])


def test_sort_meta_refuses_out_of_range_ids():
    for bad in (-1, 100):
        ids = np.array([3, bad, 5], np.int32)
        with pytest.raises(native.OutOfRangeIdsError, match=r"\[0, 100\)"):
            native.sort_meta(ids, 100)


def test_build_is_safe_from_many_threads_and_a_failure_raises(
        tmp_path, monkeypatch):
    """Builds started together each compile to a temp file of their own
    and move it into place; a failed build raises with g++'s output."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "b" / "lib.so"))
    paths, errors = [], []

    def build():
        try:
            paths.append(native._build())
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and paths == [native.LIB_PATH] * 3
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["lib.so"]
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_PATH", str(bad))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "b" / "bad.so"))
    with pytest.raises(RuntimeError, match="native parser build failed"):
        native._build()


# -- the transfer stage -----------------------------------------------------


def _batch(rng, b=6, f=4, vocab=50, meta=True):
    ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
    out = Batch(rng.integers(0, 2, b).astype(np.float32), ids,
                rng.random((b, f)).astype(np.float32),
                rng.integers(0, 3, (b, f)).astype(np.int32),
                rng.random(b).astype(np.float32))
    if meta:
        out = out._replace(sort_meta=native.sort_meta(ids, vocab))
    return out


def _drain(source, k, with_fields=False, depth=2):
    return list(DevicePrefetcher(source, k, "cpu", 50, depth=depth,
                                 with_fields=with_fields))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("meta, with_fields", [(True, False), (False, True)])
def test_shipped_views_equal_stack_batches(k, meta, with_fields):
    """Two epochs of 7 and 2 batches: super-batches of K and the epochs'
    tails at K' = leftover, each step's views equal to ``stack_batches``
    of the same group, ``seg_start`` the whole slot: the batch's U + 1
    entries, then ``n``."""
    rng = np.random.default_rng(k)
    epochs = [[_batch(rng, meta=meta) for _ in range(7)],
              [_batch(rng, meta=meta) for _ in range(2)]]
    source = [x for e, bs in enumerate(epochs) for x in bs + [EpochEnd(e)]]
    got = _drain(source, k, with_fields)
    want_sizes = []
    for bs in epochs:
        want_sizes += [len(bs[i:i + k]) for i in range(0, len(bs), k)] + ["E"]
    assert [g.n if not isinstance(g, EpochEnd) else "E" for g in got] == \
        want_sizes
    groups = [bs[i:i + k] for bs in epochs for i in range(0, len(bs), k)]
    shipped = [g for g in got if not isinstance(g, EpochEnd)]
    for sb, group in zip(shipped, groups):
        plain = stack_batches(group, with_fields)
        for i, host in enumerate(group):
            step, ref = sb.step(i), plain.step(i)
            for name in LEAVES:
                a, want = getattr(step, name), getattr(ref, name)
                if name == "fields" and not with_fields:
                    assert a is None and want is None
                    continue
                assert isinstance(a, torch.Tensor)
                np.testing.assert_array_equal(a.numpy(), want)
                np.testing.assert_array_equal(want, getattr(host, name))
            if meta:
                perm, seg = (a.numpy() for a in step.sort_meta)
                np.testing.assert_array_equal(perm, host.sort_meta.perm)
                u1 = host.sort_meta.seg_start.shape[0]
                np.testing.assert_array_equal(seg[:u1],
                                              host.sort_meta.seg_start)
                assert seg.shape == (perm.shape[0] + 1,)
                assert (seg[u1:] == perm.shape[0]).all()
            else:
                assert step.sort_meta is None and ref.sort_meta is None


def test_layout_aligns_every_leaf():
    spec, total = layout(3, 4096, 39, False, True)
    assert [s[0] for s in spec] == ["labels", "ids", "vals", "weights",
                                    "perm", "seg_start"]
    assert all(off % 128 == 0 for _, _, _, off, _ in spec)
    assert spec[-1][2] == (3, 4096 * 39 + 1) and total % 128 == 0


def test_source_errors_and_range_check_surface_in_the_consumer():
    rng = np.random.default_rng(0)

    def failing():
        yield _batch(rng)
        raise ValueError("part-7.libsvm:3: malformed")

    with pytest.raises(ValueError, match="part-7.libsvm:3"):
        _drain(failing(), 1)
    wild = _batch(rng, meta=False)
    wild.ids[0, 0] = 50
    with pytest.raises(ValueError, match=r"feature ids must lie in \[0, 50\)"):
        _drain([_batch(rng), wild], 1)


def test_close_stops_the_source_and_joins_the_thread():
    class Source:
        closed = False

        def __iter__(self):
            rng = np.random.default_rng(1)
            while not self.closed:
                yield _batch(rng)

        def close(self):
            self.closed = True

    src = Source()
    pre = DevicePrefetcher(src, 2, "cpu", 50, depth=1)
    first = next(iter(pre))
    assert first.n == 2
    pre.close()
    assert src.closed and not pre._thread.is_alive()
