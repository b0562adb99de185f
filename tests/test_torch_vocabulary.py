"""Parity of the port's place recognition with the JAX reference on the
CPU: `slam_map/vocabulary.py` (training, the tree descent, dense and
word-sparse BoW vectors, the L1 scores, the npz and DBoW2 text formats)
and `slam_map/keyframe_db.py` (the dense and the word-sparse database).

The descriptors are the port's ORB extractor's on BlobWorld frames of a
512 x 384 pinhole (four frames, 512 features each); both packages get the
same numpy arrays.

Tolerances: centers, idf, word ids, sparse word lists, top-3 slots, their
verdicts, md5s and DBoW2 text bytes exact; float vectors and scores 1e-6
relative (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_vocab_text as tvt
from openmavis_tpu.slam_map import keyframe_db as jkdb
from openmavis_tpu.slam_map import vocabulary as jvoc
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.geometry import cameras
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.slam_map import keyframe_db as tkdb
from openmavis_tpu_torch.slam_map import vocabulary as tvoc

W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
N_IMG, F = 4, 512


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread is as fast
    as eight, and eight per test worker oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def bank():
    """(desc [N_IMG, F, 256] int8, valid [N_IMG, F] bool) of the port's
    extractor on four BlobWorld frames of an orbit."""
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(40, radius=6.0, frac=0.3)
    sel = [0, 12, 25, 39]
    frames = synthetic.render_sequence(world, cameras.PINHOLE, PIN,
                                       R_wc[sel], t_wc[sel], W, H)
    cfg = tex.OrbConfig(n_features=F, n_levels=4)
    feats = [tex.extract(torch.as_tensor(f), cfg) for f in frames]
    desc = np.stack([convert._np(f.desc) for f in feats])
    valid = np.stack([convert._np(f.valid) for f in feats])
    assert valid.sum() > 1500
    return desc, valid


def _train_desc(bank):
    desc, valid = bank
    return desc[valid]


@pytest.fixture(scope="module", params=[2, 3], ids=["L2", "L3"])
def vocabs(request, bank):
    """The same vocabulary trained by both packages (k = 10)."""
    flat = _train_desc(bank)
    jv = jvoc.train(flat, k=10, levels=request.param, seed=0)
    tv = tvoc.train(flat, k=10, levels=request.param, seed=0, device="cpu")
    return jv, tv


def test_train_exact(vocabs, bank):
    """Centers per level, idf and the word ids of every descriptor equal
    exactly."""
    jv, tv = vocabs
    assert tv.k == jv.k and len(tv.centers) == len(jv.centers)
    for lv, (a, b) in enumerate(zip(tv.centers, jv.centers)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(convert._np(a), _np(b),
                                      err_msg=f"level {lv}")
    np.testing.assert_array_equal(convert._np(tv.idf), _np(jv.idf))
    desc = bank[0].reshape(-1, 256)
    np.testing.assert_array_equal(
        convert._np(tvoc.word_ids(tv, torch.as_tensor(desc))),
        _np(jvoc.word_ids(jv, jnp.asarray(desc))))
    # the words spread: not one cluster
    assert len(np.unique(convert._np(tvoc.word_ids(
        tv, torch.as_tensor(desc))))) > 10 ** (len(tv.centers) - 1)


def test_assign_cpu_route_equals_the_dense_form():
    """`_assign` on the CPU (each node's descriptors against its k centers
    as one float product) equals the dense Hamming form exactly, ties to
    the lower child included, and takes an empty bank."""
    rng = np.random.default_rng(7)
    desc = torch.as_tensor((rng.random((3000, 256)) < 0.5).astype(np.int8))
    cen = torch.as_tensor((rng.random((12, 10, 256)) < 0.5).astype(np.int8))
    cen[:, 6] = cen[:, 2]                        # tied children
    node = torch.as_tensor(rng.integers(0, 12, 3000))
    node[node == 5] = 4                          # a node with no member
    desc[:40] = cen[node[:40], 6]                # exact ties at distance 0
    got = tvoc._assign(desc, cen, node)
    assert torch.equal(got, tvoc._assign_dense(desc, cen, node))
    assert not (got == 6).any() and (got == 2).sum() >= 40
    empty = torch.zeros((0, 256), dtype=torch.int8)
    assert tvoc._assign(empty, cen, node[:0]).shape == (0,)


def test_transform_and_l1_score(vocabs, bank):
    """Dense tf-idf vectors and their L1 scores: 1e-6 relative."""
    jv, tv = vocabs
    desc, valid = bank
    tvs = [tvoc.transform(tv, torch.as_tensor(d), torch.as_tensor(v))
           for d, v in zip(desc, valid)]
    jvs = [jvoc.transform(jv, jnp.asarray(d), jnp.asarray(v))
           for d, v in zip(desc, valid)]
    for a, b in zip(tvs, jvs):
        np.testing.assert_allclose(convert._np(a), _np(b), rtol=1e-6,
                                   atol=1e-9)
        assert abs(float(a.sum()) - 1.0) < 1e-5
    got = tvoc.l1_score(torch.stack(tvs), tvs[0][None])
    ref = jvoc.l1_score(jnp.stack(jvs), jvs[0][None])
    np.testing.assert_allclose(convert._np(got), _np(ref), rtol=1e-6)
    assert float(got[0]) == pytest.approx(1.0, abs=1e-6)


def _sparse_both(jv, tv, d, v, top_w):
    jw, jwt = jvoc.transform_sparse(jv, jnp.asarray(d), jnp.asarray(v), top_w)
    tw, twt = tvoc.transform_sparse(tv, torch.as_tensor(d),
                                    torch.as_tensor(v), top_w)
    return (convert._np(tw), convert._np(twt)), (_np(jw), _np(jwt))


@pytest.mark.parametrize("top_w", [64, 512, 2000])
def test_transform_sparse(vocabs, bank, top_w):
    """Word lists exactly, weights 1e-6 relative: 64 and 512 slots cut
    among the bank's words, 2,000 exceed the 100 words of L = 2 (pad
    slots: word 0, weight 0)."""
    jv, tv = vocabs
    desc, valid = bank
    for d, v in zip(desc, valid):
        (tw, twt), (jw, jwt) = _sparse_both(jv, tv, d, v, top_w)
        assert tw.dtype == np.int32 and tw.shape == (top_w,)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_allclose(twt, jwt, rtol=1e-6, atol=1e-9)
    if top_w > tv.n_words:
        assert np.all(tw[tv.n_words:] == 0) and np.all(twt[tv.n_words:] == 0)


def test_transform_sparse_cut_among_equal_weights():
    """Every word equally heavy (one idf, each word once): the cut at
    `top_w` falls among equal weights and keeps the lowest word ids, as
    `lax.top_k` does."""
    rng = np.random.default_rng(4)
    cen0 = (rng.random((10, 256)) > 0.5).astype(np.int8)
    cen1 = (rng.random((100, 256)) > 0.5).astype(np.int8)
    # the leaf centers as queries, one for each distinct word they reach
    idf = np.ones(100, np.float32)
    jv = jvoc.Vocabulary((jnp.asarray(cen0), jnp.asarray(cen1)),
                         jnp.asarray(idf), 10)
    tv = convert.vocabulary_from_numpy(
        dict(centers=[cen0, cen1], idf=idf, k=10), device="cpu")
    words = _np(jvoc.word_ids(jv, jnp.asarray(cen1)))
    uniq = np.unique(words, return_index=True)[1]
    d = cen1[np.sort(uniq)]
    assert len(d) > 20
    v = np.ones(len(d), bool)
    (tw, twt), (jw, jwt) = _sparse_both(jv, tv, d, v, 16)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tw, np.sort(np.unique(words))[:16])
    np.testing.assert_allclose(twt, jwt, rtol=1e-6)
    assert np.all(twt == twt[0])


@pytest.fixture(scope="module")
def databases(vocabs, bank):
    """Both packages' dense and word-sparse databases over the four
    frames, and each frame's query in both forms."""
    jv, tv = vocabs
    desc, valid = bank
    top_w = 128
    K = 6
    jd, td = jkdb.allocate(K, jv.n_words), tkdb.allocate(K, tv.n_words,
                                                         device="cpu")
    js, ts = jkdb.allocate_sparse(K, top_w), tkdb.allocate_sparse(
        K, top_w, device="cpu")
    q = []
    for k, (d, v) in enumerate(zip(desc, valid)):
        jb = jvoc.transform(jv, jnp.asarray(d), jnp.asarray(v))
        tb = tvoc.transform(tv, torch.as_tensor(d), torch.as_tensor(v))
        jw = jvoc.transform_sparse(jv, jnp.asarray(d), jnp.asarray(v), top_w)
        tw = tvoc.transform_sparse(tv, torch.as_tensor(d),
                                   torch.as_tensor(v), top_w)
        slot = k + 1            # slot 0 stays empty
        jd, td = jkdb.add(jd, slot, jb), tkdb.add(td, slot, tb)
        js = jkdb.add_sparse(js, slot, *jw)
        ts = tkdb.add_sparse(ts, slot, *tw)
        q.append(((jb, jw), (tb, tw)))
    return jv, tv, (jd, td), (js, ts), q


_COV = np.array([0, 20, 30, 5, 16, 0], np.int32)


@pytest.mark.parametrize("exclude_slot", [None, 1])
def test_query_dense_and_sparse(databases, exclude_slot):
    """`query` / `query_sparse`: scores 1e-6, the top-3 slots and their
    verdicts exact, at a floor between the scores; `scores_sparse` 1e-6."""
    jv, tv, (jd, td), (js, ts), q = databases
    K = td.valid.shape[0]
    exc = np.zeros(K, bool)
    if exclude_slot is not None:
        exc[exclude_slot] = True
    for (jb, jw), (tb, tw) in q:
        # dense
        js_, jt, jo = jkdb.query(jd, jb, jnp.asarray(exc), jnp.asarray(0.05))
        ts_, tt, to = tkdb.query(td, tb, torch.as_tensor(exc), 0.05)
        np.testing.assert_allclose(convert._np(ts_), _np(js_), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(convert._np(tt), _np(jt))
        np.testing.assert_array_equal(convert._np(to), _np(jo))
        # word-sparse
        sc_t = tkdb.scores_sparse(ts, *tw, tv.n_words)
        sc_j = jkdb.scores_sparse(js, *jw, jv.n_words)
        np.testing.assert_allclose(convert._np(sc_t), _np(sc_j), rtol=1e-6,
                                   atol=1e-7)
        # a floor halfway between the second and the third score
        floor = float(np.sort(_np(sc_j))[-3:-1].mean())
        js_, jt, jo = jkdb.query_sparse(js, *jw, jnp.asarray(exc),
                                        jnp.asarray(floor), jv.n_words)
        ts_, tt, to = tkdb.query_sparse(ts, *tw, torch.as_tensor(exc),
                                        floor, tv.n_words)
        np.testing.assert_allclose(convert._np(ts_), _np(js_), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(convert._np(tt), _np(jt))
        np.testing.assert_array_equal(convert._np(to), _np(jo))
    # a frame scores itself highest
    (jb, jw), (tb, tw) = q[2]
    assert int(tkdb.query_sparse(ts, *tw, torch.zeros(K, dtype=torch.bool),
                                 0.0, tv.n_words)[1][0]) == 3


def test_scores_sparse_takes_the_max_at_word_zero(databases):
    """A query whose real word 0 has weight and whose pad slots alias word
    0 with weight 0: the scatter keeps the real weight in both packages."""
    jv, tv, _, (js, ts), _ = databases
    word = np.array([0, 5, 0, 0], np.int32)
    wt = np.array([0.4, 0.6, 0.0, 0.0], np.float32)
    got = tkdb.scores_sparse(ts, torch.as_tensor(word), torch.as_tensor(wt),
                             tv.n_words)
    ref = jkdb.scores_sparse(js, jnp.asarray(word), jnp.asarray(wt),
                             jv.n_words)
    np.testing.assert_allclose(convert._np(got), _np(ref), rtol=1e-6)
    dense = np.zeros(tv.n_words, np.float32)
    dense[0], dense[5] = 0.4, 0.6
    db_w, db_wt = convert._np(ts.word), convert._np(ts.wt)
    want = np.minimum(db_wt, dense[db_w]).sum(-1)
    np.testing.assert_allclose(convert._np(got), want, rtol=1e-6)


def test_min_covisible_score(databases):
    """The covisible-score floor, dense and sparse: 1e-6; 0 with no
    covisible keyframe."""
    jv, tv, (jd, td), (js, ts), q = databases
    (jb, jw), (tb, tw) = q[0]
    for cov, thr in ((_COV, 15), (_COV, 100)):
        got = tkdb.min_covisible_score(td, tb, torch.as_tensor(cov), thr)
        ref = jkdb.min_covisible_score(jd, jb, jnp.asarray(cov), thr)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        got = tkdb.min_covisible_score_sparse(ts, *tw, torch.as_tensor(cov),
                                              tv.n_words, thr)
        ref = jkdb.min_covisible_score_sparse(js, *jw, jnp.asarray(cov),
                                              jv.n_words, thr)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        if thr == 100:
            assert float(got) == 0.0


def test_l1_score_sparse(databases):
    """The min-intersection L1 of two sparse vectors: 1e-6, and equal to
    the dense L1 score of the same frames (every word kept)."""
    jv, tv, _, _, q = databases
    (jb0, jw0), (tb0, tw0) = q[0]
    (jb1, jw1), (tb1, tw1) = q[1]
    got = tvoc.l1_score_sparse(*tw0, *tw1, tv.n_words)
    ref = jvoc.l1_score_sparse(*jw0, *jw1, jv.n_words)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_npz_loads_in_both_packages(vocabs, tmp_path):
    """An npz saved by either package loads in the other with the same
    md5 and equal arrays; a corrupted file raises ValueError in both."""
    jv, tv = vocabs
    pt, pj = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    md5_t = tvoc.save(pt, tv)
    md5_j = jvoc.save(pj, jv)
    assert md5_t == md5_j
    for path in (pt, pj):
        v_j, d_j = jvoc.load(path)
        v_t, d_t = tvoc.load(path, device="cpu")
        assert d_j == d_t == md5_t
        for a, b in zip(v_t.centers, v_j.centers):
            np.testing.assert_array_equal(convert._np(a), _np(b))
        np.testing.assert_array_equal(convert._np(v_t.idf), _np(v_j.idf))
        assert v_t.k == v_j.k == 10
    # corrupt one idf entry, keep the stored hash
    with np.load(pt) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    arrays["idf"] = arrays["idf"].copy()
    arrays["idf"][3] += 1.0
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="content hash"):
        jvoc.load(bad)
    with pytest.raises(ValueError, match="content hash"):
        tvoc.load(bad, device="cpu")


def test_save_dbow2_text_bytes(vocabs, tmp_path):
    """The DBoW2 text file of one vocabulary is byte-identical from both
    packages, and loads back (with `load`'s `.txt` dispatch) to the same
    tree and the raw file's md5."""
    jv, tv = vocabs
    pt, pj = tmp_path / "port.txt", tmp_path / "ref.txt"
    tvoc.save_dbow2_text(str(pt), tv)
    jvoc.save_dbow2_text(str(pj), jv)
    assert pt.read_bytes() == pj.read_bytes()
    v_t, d_t = tvoc.load(str(pt), device="cpu")
    _, d_j = jvoc.load(str(pj))
    assert d_t == d_j
    for a, b in zip(v_t.centers, tv.centers):
        np.testing.assert_array_equal(convert._np(a), convert._np(b))
    np.testing.assert_array_equal(convert._np(v_t.idf), convert._np(tv.idf))


def _incomplete(tmp_path):
    p = tmp_path / "incomplete.txt"
    tvt._write_lines(p, 3, 1, [(0, 1, tvt._bits([0]), 0.5),
                               (0, 1, tvt._bits(range(128)), 0.25)])
    return p, np.stack([tvt._bits([0]), tvt._bits(range(128)),
                        tvt._bits(range(100))])


def _early_leaf(tmp_path):
    lf, c0 = tvt._bits(range(200, 256)), tvt._bits(range(0, 32))
    c1 = tvt._bits(range(32, 96))
    p = tmp_path / "early_leaf.txt"
    tvt._write_lines(p, 2, 2, [(0, 1, lf, 0.7),
                               (0, 0, tvt._bits(range(0, 64)), 0.0),
                               (2, 1, c0, 0.4), (2, 1, c1, 0.3)])
    return p, np.stack([lf, c0, c1])


@pytest.mark.parametrize("case", [_incomplete, _early_leaf],
                         ids=["incomplete_tree", "early_leaf"])
def test_load_dbow2_text_incomplete_trees(case, tmp_path):
    """`test_vocab_text.py`'s hand-written incomplete trees (a node with
    fewer than k children; a leaf above the bottom level): equal centers
    and idf, and the same words for the same descriptors."""
    path, q = case(tmp_path)
    tv = tvoc.load_dbow2_text(str(path), device="cpu")
    jv = jvoc.load_dbow2_text(str(path))
    assert tv.k == jv.k
    for a, b in zip(tv.centers, jv.centers):
        np.testing.assert_array_equal(convert._np(a), _np(b))
    np.testing.assert_array_equal(convert._np(tv.idf), _np(jv.idf))
    np.testing.assert_array_equal(
        convert._np(tvoc.word_ids(tv, torch.as_tensor(q))),
        _np(jvoc.word_ids(jv, jnp.asarray(q))))


def test_vocabulary_round_trip(vocabs):
    """`convert.vocabulary_{to,from}_numpy` and the sparse database's:
    the dtypes the port allocates, the values unchanged."""
    _, tv = vocabs
    d = convert.vocabulary_to_numpy(tv)
    back = convert.vocabulary_from_numpy(d, device="cpu")
    for a, b in zip(back.centers, tv.centers):
        assert a.dtype == torch.int8
        assert torch.equal(a, b)
    assert back.idf.dtype == torch.float32 and torch.equal(back.idf, tv.idf)
    db = tkdb.allocate_sparse(4, 8, device="cpu")
    db = tkdb.add_sparse(db, 2, torch.arange(8, dtype=torch.int32),
                         torch.linspace(0, 1, 8))
    back = convert.sparse_kfdb_from_numpy(convert.sparse_kfdb_to_numpy(db),
                                          device="cpu")
    for a, b in zip(back, db):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_entry_points_need_a_card_by_default(bank):
    """Training and loading build on the card unless the caller names a
    device; without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvoc.train(_train_desc(bank)[:100], k=3, levels=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkdb.allocate_sparse(4, 8)
