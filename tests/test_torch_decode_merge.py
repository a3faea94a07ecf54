"""The partial form of the decode attention and the merge across ranks
(``ops.decode_attention_partial`` and ``ops.merge_partials``, the pieces
of ``blocks.decode_attention_sharded``) on the CPU.

A cache's slots split into R equal ranges, each range's partial (o, lse)
from the plain version, merged, against one ``decode_attention_ref``
call over all the slots and against the JAX package's Pallas
``decode_attention`` in interpret mode (on rows with a key: ROADMAP C 2,
the reference's kernel gives a row of length 0 the mean of v, the port
0): ragged lengths, so that some ranges hold no key, a row of length 0
in every range (it gives 0), R in {1, 2, 3, 8}, grouped heads and one
head a kv head.  fp32 at 2e-5, the
tolerance of ``tests/test_torch_kernels.py``.  A row of length 0 is shown
in each package by ``test_length_0_in_each_package`` (C 2's decode half,
settled: the port keeps 0).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

#: (n, hq, hkv, S, d, lengths): S = 48 splits into 1, 2, 3 and 8 ranges;
#: lengths at the end, inside one range, at a range's edge, 1 and 0
SHAPES = [(5, 8, 2, 48, 16, (48, 17, 18, 1, 0)),
          (3, 4, 4, 48, 8, (30, 0, 6))]
PARTS = (1, 2, 3, 8)


def arrs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def split_merge(q, kc, vc, lens, parts):
    """The partial form on each of ``parts`` slot ranges at the lengths a
    rank computes from the global ones, then the merge."""
    s_l = kc.shape[2] // parts
    os_, lses = [], []
    for r in range(parts):
        sl = slice(r * s_l, (r + 1) * s_l)
        o, lse = ops.decode_attention_partial(
            q, kc[:, :, sl].contiguous(), vc[:, :, sl].contiguous(),
            torch.clamp(lens - r * s_l, 0, s_l))
        assert o.dtype == lse.dtype == torch.float32
        os_.append(o)
        lses.append(lse)
    return ops.merge_partials(torch.stack(os_), torch.stack(lses), q.dtype)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", SHAPES)
def test_split_and_merged_is_one_call(n, hq, hkv, s, d, lengths, parts):
    q, kc, vc = (torch.from_numpy(a) for a in arrs(
        3, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = split_merge(q, kc, vc, lens, parts)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    jwant = jdecode(*(jnp.asarray(t.numpy()) for t in (q, kc, vc, lens)),
                    interpret=True)
    keyed = [i for i, n_keys in enumerate(lengths) if n_keys > 0]
    empty = [i for i, n_keys in enumerate(lengths) if n_keys == 0]
    np.testing.assert_allclose(got[keyed].numpy(), np.asarray(jwant)[keyed],
                               atol=2e-5, rtol=2e-5)
    assert empty and torch.equal(got[empty], torch.zeros_like(got[empty]))


@pytest.mark.parametrize("n,hq,hkv,s,d,lengths", SHAPES)
def test_partial_form_is_the_unrounded_row_and_its_lse(n, hq, hkv, s, d,
                                                       lengths):
    """o is ``decode_attention_ref`` before its rounding (bit for bit in
    fp32), lse the float64 log-sum-exp of the scaled scores within 2e-5;
    a row of length 0 gives o = 0 and lse = -inf."""
    q, kc, vc = arrs(4, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d))
    lens = np.array(lengths, np.int32)
    o, lse = ops.decode_attention_partial(*(torch.from_numpy(a) for a in (
        q, kc, vc, lens)))
    assert torch.equal(o, ref.decode_attention_ref(*(
        torch.from_numpy(a) for a in (q, kc, vc, lens))))
    rep = hq // hkv
    k64 = np.repeat(kc.astype(np.float64), rep, axis=1)
    scores = np.einsum("nhd,nhsd->nhs", q.astype(np.float64), k64) * d ** -0.5
    for i, n_keys in enumerate(lengths):
        if n_keys == 0:
            assert np.all(np.isneginf(lse[i].numpy()))
            assert not o[i].any()
            continue
        row = scores[i, :, :n_keys]
        top = row.max(axis=1)
        want = top + np.log(np.exp(row - top[:, None]).sum(axis=1))
        np.testing.assert_allclose(lse[i].numpy(), want, atol=2e-5,
                                   rtol=2e-5)


def test_merge_weights_empty_parts_zero():
    """A part with no keys (lse -inf, o 0) changes nothing, wherever it
    sits, and the merge is the same bits on every call with the same
    parts."""
    r = np.random.default_rng(6)
    o = torch.from_numpy(r.standard_normal((3, 2, 4, 8)).astype(np.float32))
    lse = torch.from_numpy(r.standard_normal((3, 2, 4)).astype(np.float32))
    o[1], lse[1] = 0.0, float("-inf")
    got = ops.merge_partials(o, lse, torch.float32)
    keep = ops.merge_partials(o[[0, 2]], lse[[0, 2]], torch.float32)
    np.testing.assert_allclose(got.numpy(), keep.numpy(), atol=1e-7,
                               rtol=1e-7)
    assert torch.equal(got, ops.merge_partials(o.clone(), lse.clone(),
                                               torch.float32))


def test_length_0_in_each_package():
    """ROADMAP C 2, the decode half: a batch with one sequence of length 0
    and finite garbage (uniform in +-50) in every slot at or past each
    length.  The JAX package's Pallas kernel in interpret mode gives that
    row the mean of v over all S slots (every score is ``NEG_INF = -1e30``,
    so every p is 1), its plain version NaN (a softmax over -inf alone),
    the port 0: ``decode_attention_ref`` 0, ``decode_attention_partial_ref``
    o = 0 and lse = -inf, which ``merge_partials`` needs from an empty slot
    range.  The rows with keys agree in all of them within 2e-5 (fp32)."""
    n, hq, hkv, s, d = 3, 8, 2, 48, 16
    lengths = (17, 0, 48)
    q, kc, vc = arrs(7, (n, hq, d), (n, hkv, s, d), (n, hkv, s, d))
    r = np.random.default_rng(8)
    for i, n_keys in enumerate(lengths):
        for c in (kc, vc):
            c[i, :, n_keys:] = r.uniform(-50, 50, c[i, :, n_keys:].shape)
    lens = np.array(lengths, np.int32)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    pallas = np.asarray(jdecode(*jargs, interpret=True))
    mean_v = np.repeat(vc[1].mean(axis=1), hq // hkv, axis=0)   # [hq, d]
    np.testing.assert_allclose(pallas[1], mean_v, atol=1e-4, rtol=1e-5)
    jax_plain = np.asarray(jref.decode_attention_ref(*jargs))
    assert np.isnan(jax_plain[1]).all()
    targs = [torch.from_numpy(a) for a in (q, kc, vc, lens)]
    port = ref.decode_attention_ref(*targs)
    o, lse = ref.decode_attention_partial_ref(*targs)
    assert not port[1].abs().max() and not o[1].abs().max()
    assert torch.isneginf(lse[1]).all()
    keyed = [0, 2]
    for name, want in (("pallas", pallas), ("jax plain", jax_plain)):
        for got in (port, o):
            np.testing.assert_allclose(got[keyed].numpy(), want[keyed],
                                       atol=2e-5, rtol=2e-5, err_msg=name)
