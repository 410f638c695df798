"""The generator: deterministic per seed, and hashed as the port's
parsers hash."""

import numpy as np
import pytest

from fast_tffm_tpu_torch.data import libsvm, native
from portbench import gen, run
from portbench.reference import fm as ref_fm

from .conftest import CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_lines_are_a_function_of_the_seed(cell):
    spec = run.load_cell(cell)
    schema, mix = spec["config"]["schema"], spec["traffic"]
    a = gen.make_lines(schema, mix, 300, 2**31 + 5)
    b = gen.make_lines(schema, mix, 300, 2**31 + 5)
    c = gen.make_lines(schema, mix, 300, 2**31 + 6)
    assert a.text.tobytes() == b.text.tobytes()
    assert a.text.tobytes() != c.text.tobytes()
    assert np.array_equal(a.labels, b.labels)
    # One line a row, all of one length, the schema's fields in order.
    rows = a.text.tobytes().decode().splitlines()
    assert len(rows) == 300 and len({len(r) for r in rows}) == 1
    toks = rows[0].split()
    assert toks[0] in ("0", "1")
    assert [t.split("_")[0] for t in toks[1:]] == [
        f[0].split("_")[0] for f in schema["fields"]]
    assert 0.05 < a.labels.mean() < 0.95


@pytest.mark.parametrize("cell", CELLS)
def test_the_exponent_is_the_one_the_published_counts_imply(cell):
    """The configuration's exponent is the median of those its fields of
    a million distinct values or more imply at the dataset's line
    count, and the law at it draws those counts."""
    config = run.load_cell(cell)["config"]
    schema, assumed = config["schema"], config["assumed"]
    lines = assumed["dataset_lines"]
    fields = {f[0]: f[2] for f in schema["fields"]
              if f[1] == "categorical" and f[2] >= 10**6}
    implied = {name: gen.implied_exponent(d, lines)
               for name, d in fields.items()}
    assert implied == pytest.approx(assumed["zipf_exponent_by_field"],
                                    abs=1e-4)
    assert schema["zipf_exponent"] == pytest.approx(
        float(np.median(list(implied.values()))), abs=1e-3)
    for name, a in implied.items():
        assert gen.expected_distinct(a, lines) == pytest.approx(
            fields[name], rel=1e-3)


def test_zipf_is_skewed():
    spec = run.load_cell("criteo_kaggle.cached_zipf")
    schema = spec["config"]["schema"]
    lines = gen.make_lines(schema, spec["traffic"], 4096, 7)
    j = [f[0] for f in schema["fields"]].index("C3")  # 10 M distinct
    _, counts = np.unique(lines.keys[j], axis=0, return_counts=True)
    assert counts.max() > 100 and counts.size > 1000


@pytest.mark.parametrize("cell", CELLS)
def test_murmur_copy_is_the_parsers_hash(cell):
    spec = run.load_cell(cell)
    lines = gen.make_lines(spec["config"]["schema"], spec["traffic"], 64, 11)
    vocab = int(spec["config"]["cfg"]["General"]["vocabulary_size"])
    for key in lines.keys:
        ours = ref_fm.murmur64a(key)
        for row, h in zip(key[:8], ours[:8].tolist()):
            assert libsvm.murmur64(row.tobytes()) == h
            assert native.murmur64_native(row.tobytes()) == h
    # The native parser's ids of whole lines are the copy's, modulo V.
    mf = int(spec["config"]["cfg"]["Tpu"]["max_features"])
    text = lines.text.tobytes().decode().splitlines()
    batch = native.NativeParser(vocab, mf, True).parse_batch(text, 64)
    ids = np.stack([ref_fm.murmur64a(k) % np.uint64(vocab)
                    for k in lines.keys], axis=1).astype(np.int64)
    assert np.array_equal(batch.ids[:, :ids.shape[1]], ids)
    assert not batch.ids[:, ids.shape[1]:].any()
    vals = np.stack(lines.vals, axis=1)
    assert np.array_equal(batch.vals[:, :vals.shape[1]], vals)
    assert np.array_equal(batch.labels, lines.labels.astype(np.float32))
