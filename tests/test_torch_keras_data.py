"""The port's Dataset and column transformers against ``distkeras_tpu``'s,
on the same numpy columns: rows and their order equal exactly (shuffle,
split, shard, batch streams with and without a window), transformer
outputs equal exactly."""

import numpy as np
import pytest

from distkeras_tpu.data import dataset as jds
from distkeras_tpu.data import transformers as jtr
from distkeras_tpu_torch.data import dataset as tds
from distkeras_tpu_torch.data import transformers as ttr


def columns(n=101):
    rng = np.random.default_rng(0)
    return {"features": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "label": rng.integers(0, 5, n),
            "id": np.arange(n)}


def both(cols):
    return jds.Dataset(cols), tds.Dataset(cols)


def same(a, b):
    assert a.columns == b.columns and len(a) == len(b)
    for name in a.columns:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])


def test_constructors_and_accessors():
    cols = columns()
    j, t = both(cols)
    same(j, t)
    x, y = cols["features"], cols["label"]
    same(jds.Dataset.from_arrays(x, y), tds.Dataset.from_arrays(x, y))
    same(jds.Dataset.from_arrays(x, features_col="f"),
         tds.Dataset.from_arrays(x, features_col="f"))
    same(j.with_column("z", y * 2), t.with_column("z", y * 2))
    same(j.drop("id"), t.drop("id"))
    same(j.select("label", "id"), t.select("label", "id"))
    same(j.take(7), t.take(7))
    same(j.repeat(3), t.repeat(3))
    with pytest.raises(ValueError, match="mismatch"):
        tds.Dataset({"a": np.zeros(3), "b": np.zeros(4)})
    with pytest.raises(ValueError, match="at least one"):
        tds.Dataset({})


@pytest.mark.parametrize("seed", [0, 7, None])
def test_shuffle_split_shard_rows_and_order(seed):
    j, t = both(columns())
    if seed is not None:
        same(j.shuffle(seed), t.shuffle(seed))
        for frac in (0.29, 0.5, 0.9):
            for a, b in zip(j.split(frac, seed), t.split(frac, seed)):
                same(a, b)
    for i in range(3):
        same(j.shard(i, 3), t.shard(i, 3))
    with pytest.raises(ValueError, match="empty part"):
        t.split(0.001, 0)
    with pytest.raises(ValueError, match="out of range"):
        t.shard(3, 3)


@pytest.mark.parametrize("bs,window,drop", [(8, None, True), (8, None, False),
                                            (4, 3, True), (101, None, True)])
def test_batch_streams_equal(bs, window, drop):
    j, t = both(columns())
    a = list(j.batches(bs, window=window, drop_remainder=drop))
    b = list(t.batches(bs, window=window, drop_remainder=drop))
    assert len(a) == len(b) == (j.num_batches(bs, window) if drop
                                else -(-len(j) // bs))
    assert t.num_batches(bs, window) == j.num_batches(bs, window)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    nolabel = list(t.batches(bs, label_col=None, window=window,
                             drop_remainder=drop))
    np.testing.assert_array_equal(nolabel[0], a[0][0])
    with pytest.raises(ValueError, match="drop_remainder"):
        t.batches(4, window=2, drop_remainder=False)
    pre = list(t.batches(bs, window=window, drop_remainder=drop,
                         prefetch=2))
    ref = list(j.batches(bs, window=window, drop_remainder=drop,
                         prefetch=2))
    assert len(pre) == len(ref) == len(a)
    for (xa, ya), (xb, yb) in zip(ref, pre):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_from_csv_equal(tmp_path):
    path = tmp_path / "d.csv"
    rng = np.random.default_rng(1)
    data = rng.normal(size=(6, 4)).round(3)
    lines = ["a,b,c,y"] + [",".join(map(str, r)) for r in data]
    path.write_text("\n".join(lines) + "\n")
    same(jds.Dataset.from_csv(str(path), label_col="y"),
         tds.Dataset.from_csv(str(path), label_col="y"))
    headless = tmp_path / "h.csv"
    headless.write_text("\n".join(lines[1:]) + "\n")
    same(jds.Dataset.from_csv(str(headless), label_col=3, skip_header=0),
         tds.Dataset.from_csv(str(headless), label_col=3, skip_header=0))


def test_transformers_equal():
    rng = np.random.default_rng(2)
    n = 40
    cols = {"features": rng.normal(size=(n, 6)).astype(np.float32) * 5,
            "label": rng.integers(0, 4, n),
            "prediction": rng.normal(size=(n, 4)).astype(np.float32),
            "idx": np.array([rng.choice(9, size=int(k), replace=False)
                             for k in rng.integers(0, 4, n)], dtype=object),
            "val": None}
    cols["val"] = np.array([rng.normal(size=len(i)).astype(np.float32)
                            for i in cols["idx"]], dtype=object)
    j, t = both(cols)
    pairs = [
        (jtr.OneHotTransformer(4), ttr.OneHotTransformer(4)),
        (jtr.LabelIndexTransformer(), ttr.LabelIndexTransformer()),
        (jtr.MinMaxTransformer(), ttr.MinMaxTransformer()),
        (jtr.MinMaxTransformer(o_min=-20, o_max=20, n_min=-1, n_max=1,
                               output_col="mm"),
         ttr.MinMaxTransformer(o_min=-20, o_max=20, n_min=-1, n_max=1,
                               output_col="mm")),
        (jtr.StandardScaleTransformer(), ttr.StandardScaleTransformer()),
        (jtr.ReshapeTransformer("features", "img", (2, 3)),
         ttr.ReshapeTransformer("features", "img", (2, 3))),
        (jtr.DenseTransformer(), ttr.DenseTransformer()),
        (jtr.DenseTransformer(output_col="dense", size=9, indices_col="idx",
                              values_col="val"),
         ttr.DenseTransformer(output_col="dense", size=9, indices_col="idx",
                              values_col="val")),
    ]
    for jt, tt in pairs:
        a, b = jt(j), tt.transform(t)
        for name in a.columns:
            if a[name].dtype != object:
                np.testing.assert_array_equal(a[name], b[name])
    # Fit-once: the second dataset reuses the first one's statistics.
    jst, tst = jtr.StandardScaleTransformer(), ttr.StandardScaleTransformer()
    jst(j), tst(t)
    np.testing.assert_array_equal(jst(j.take(5))["features"],
                                  tst(t.take(5))["features"])
    with pytest.raises(ValueError, match="size="):
        ttr.DenseTransformer(indices_col="idx", values_col="val")(t)
