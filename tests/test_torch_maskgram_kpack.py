"""The bits route's carry products B9 and B14 as one GEMM over the mask
packed along the cells (``singlet_tpu_torch/ops/maskgram.py``): the plain
versions of their passes, ``pack_words_k`` (bitplane words) and
``pack_mask8_k`` (the prebuilt int8 mask), against ``pack_mask_k``, the
plain version of the hash pass that B11's GEMM reads; the K-major operand
layout that int8 B9/B14 read in place (``kmajor_buffer``,
``kmajor_pitch``); the plain B9 and B14 fed that layout against contiguous
P and against the JAX kernels in interpret mode; and the build digest that
names each CUDA library after its source and the headers it includes.

Tolerances: the passes give the words of ``pack_mask_k`` for the same
seed and cells bit for bit. On int8 the plain B9/B14 sum exact integers
and dequantize with one rounding, so any layout of P gives the same bits,
and the JAX kernels' within rtol = atol = 1e-6 (tests/test_torch_maskbits.py's
EXACT8); on bf16 they sum float32 in another order than the JAX kernels
(rtol = atol = 1e-5, its BF16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlet_tpu.ops import maskbits as jmb
from singlet_tpu.ops import pallas_maskgram as jmg
from singlet_tpu.ops.linalg import packed_outer_products as j_packed
from singlet_tpu.ops.linalg import pad_pairs
from singlet_tpu.ops.rngmask import seed_pair as jax_seed_pair
from singlet_tpu_torch import _build
from singlet_tpu_torch.ops import maskbits, maskgram, maskgram_cuda
from singlet_tpu_torch.ops.linalg import packed_outer_products, triu_pairs
from singlet_tpu_torch.ops.rngmask import seed_pair

EXACT8 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread in this module: the suite runs one worker
    process per core, and a thread pool per worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (cells, offset, gene_block, n_gb, cells_true, genes_true): one word group
# unclamped; 40 gene blocks (a second, partial word group), 300 cells (no
# multiple of 32: the tail bits zero) at an offset, both clamps; gene_block
# 1720 (no multiple of the 32 word columns a block of the pass takes); 33
# cells of 40 genes in gene blocks of 8
PACK_GEOMS = {"one_group": (1000, 0, 256, 3, 1000, 768),
              "forty_gene_blocks": (300, 12345, 32, 40, 12345 + 250, 1263),
              "gene_block_1720": (100, 4096, 1720, 2, 4096 + 90, 3440),
              "tail": (33, 7, 8, 5, 7 + 33, 37)}


def _pack_inputs(geom, seed=41, inv=5):
    cells, offset, gb, n_gb, cells_true, genes_true = PACK_GEOMS[geom]
    genes = gb * n_gb
    ids = torch.arange(offset, offset + cells)
    kw = dict(inv_density=inv, cells_true=cells_true, genes_true=genes_true)
    words = maskbits.pack_mask_words(seed_pair(seed), ids, genes_pad=genes,
                                     gene_block=gb, **kw)
    want = maskgram.pack_mask_k(seed_pair(seed), ids, genes, gene_rows=True,
                                **kw)
    return words, want, gb, genes


@pytest.mark.parametrize("geom", sorted(PACK_GEOMS))
def test_pack_words_k_equals_pack_mask_k(geom):
    words, want, gb, genes = _pack_inputs(geom)
    got = maskgram.pack_words_k(words, gene_block=gb, genes_pad=genes)
    assert got.dtype == torch.int32
    assert got.shape == (genes, maskgram.k_words(words.shape[0]))
    assert torch.equal(got, want)
    # at least one held-out entry, so the comparison is not of zeros
    assert bool((want != 0).any())


@pytest.mark.parametrize("geom", sorted(PACK_GEOMS))
def test_pack_mask8_k_equals_pack_mask_k(geom):
    words, want, gb, genes = _pack_inputs(geom)
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    assert torch.equal(maskgram.pack_mask8_k(m8), want)


def test_pass_wrappers_take_plain_versions_on_cpu():
    words, want, gb, genes = _pack_inputs("forty_gene_blocks")
    m8 = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                         genes_pad=genes)
    before = maskgram_cuda.LAUNCHES_KPACK
    assert torch.equal(maskgram_cuda.pack_words_k_cuda(
        words, gene_block=gb, genes_pad=genes), want)
    assert torch.equal(maskgram_cuda.pack_mask8_k_cuda(m8), want)
    assert maskgram_cuda.LAUNCHES_KPACK == before


@pytest.mark.parametrize("cells,npairs", [(2048, 5050), (40, 3), (1000, 21)])
def test_kmajor_buffer_layout(cells, npairs):
    P = maskgram.kmajor_buffer(cells, npairs, "cpu")
    assert P.shape == (cells, npairs) and P.dtype == torch.int8
    pitch = -(-cells // 16) * 16
    assert P.stride() == (1, pitch)
    assert maskgram.kmajor_pitch(P) == pitch
    # a row slice at a multiple of 16 is read in place, at the same pitch
    if cells >= 32:
        assert maskgram.kmajor_pitch(P[16:32]) == pitch
    # anything else is copied by the wrapper: contiguous P, a row slice off
    # the 16-byte grid, a pitch that is no multiple of 16, bf16
    assert maskgram.kmajor_pitch(P.contiguous()) is None
    assert maskgram.kmajor_pitch(P[1:]) is None
    odd = torch.empty((npairs, cells + 1), dtype=torch.int8)[:, :cells].T
    assert maskgram.kmajor_pitch(odd) is None
    assert maskgram.kmajor_pitch(P.to(torch.bfloat16)) is None


# (genes, gene_block, cells, scale_block, k): tests/test_torch_maskbits.py's
# one group, three groups with gene slabs, 64 gene blocks; sub-blocks of 40
# cells (no multiple of the 32-cell word)
MPH_GEOMETRIES = {"one_group": (96, 32, 48, 48, 5),
                  "three_groups_slabs": (128, 32, 48, 16, 4),
                  "two_word_groups": (512, 8, 32, 16, 3),
                  "sub_blocks_of_40": (64, 32, 120, 40, 3)}


def _jax_words(seed, cells, genes, gene_block, inv, cells_true, genes_true):
    kw = dict(genes_pad=genes, gene_block=gene_block, inv_density=inv,
              cells_true=cells_true, genes_true=genes_true)
    got = maskbits.pack_mask_words(seed_pair(seed), torch.arange(cells), **kw)
    want = jmb.pack_mask_words(jax_seed_pair(seed),
                               jnp.arange(cells, dtype=jnp.int32), **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    return got, want


def _group_operands(rng, cells, scale_block, k, dtype):
    """Per quantization group its own packed products (int8 quantized, or
    bf16), stacked contiguous, and the same for JAX (pairs padded to 128),
    with the scales."""
    H = rng.random((cells, k)).astype(np.float32)
    iu = triu_pairs(k)
    ops, scales, opsj, scalesj = [], [], [], []
    for c0 in range(0, cells, scale_block):
        X = H[c0:c0 + scale_block]
        P = packed_outer_products(torch.as_tensor(X), iu)
        Pj = j_packed(jnp.asarray(X), pad_pairs(iu, 128))
        if dtype == "int8":
            q, s = maskgram.quantize_pairs(P, axis=0)
            qj, sj = jmg.quantize_pairs(Pj, axis=0)
        else:
            q, s = P.to(torch.bfloat16), torch.ones(P.shape[1])
            qj, sj = Pj.astype(jnp.bfloat16), jnp.ones((Pj.shape[1],),
                                                       jnp.float32)
        ops.append(q)
        scales.append(s)
        opsj.append(qj)
        scalesj.append(sj)
    return (torch.cat(ops), torch.stack(scales, dim=1),
            jnp.concatenate(opsj), jnp.stack(scalesj, axis=1),
            iu[0].shape[0])


def _engine_layout(op):
    """``op`` as the engine hands it over: int8 in the rows of a K-major
    group buffer, bf16 in a pair-padded one."""
    make = maskgram.kmajor_buffer if op.dtype == torch.int8 \
        else maskgram.pair_buffer
    buf = make(op.shape[0], op.shape[1], "cpu")
    buf.copy_(op)
    assert not buf.is_contiguous()
    return buf


@pytest.mark.parametrize("kernel", ["B9", "B14"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("geom", sorted(MPH_GEOMETRIES))
def test_carry_products_on_engine_layout_match_jax(rng, geom, dtype,
                                                   kernel):
    genes, gb, cells, scale_block, k = MPH_GEOMETRIES[geom]
    words, jwords = _jax_words(29, cells, genes, gb, 5, cells - 5,
                               genes - 3)
    op, s, opj, sj, npairs = _group_operands(rng, cells, scale_block, k,
                                             dtype)
    acc0 = rng.random((128, genes)).astype(np.float32)
    kw = dict(gene_block=gb, scale_block=scale_block)
    if kernel == "B9":
        plain = maskgram.mask_packed_h_t_bits_plain
        mask = words
        want = jmg.mask_packed_h_t_bits(opj, sj, jwords, jnp.asarray(acc0),
                                        interpret=True, **kw)
    else:
        plain = maskgram.mask_packed_h_t_m8_plain
        mask = maskbits.unpack_mask_bits_plain(words, gene_block=gb,
                                               genes_pad=genes)
        want = jmg.mask_packed_h_t_m8(opj, sj, jnp.asarray(mask.numpy()),
                                      jnp.asarray(acc0), interpret=True,
                                      **kw)
    acc = torch.as_tensor(acc0[:npairs].copy())
    got = plain(_engine_layout(op), s, mask, acc, **kw)
    assert got is acc
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:npairs],
                               **(EXACT8 if dtype == "int8" else BF16))
    if dtype == "int8":
        contiguous = plain(op, s, mask, torch.as_tensor(
            acc0[:npairs].copy()), **kw)
        assert torch.equal(got, contiguous)


def _write(path, text):
    path.write_text(text)
    return path


def test_source_digest_follows_local_headers(tmp_path):
    """A library is named after its source, the local headers it includes
    (recursively) and the flags: editing any header gives a new name, so a
    stale build is never loaded; files it does not include do not count."""
    src = _write(tmp_path / "k.cu",
                 '#include <stdint.h>\n#include "a.cuh"\nint f() {}\n')
    a = _write(tmp_path / "a.cuh", '  #  include "b.cuh"\n#include "a.cuh"\n')
    b = _write(tmp_path / "b.cuh", "constexpr int kB = 1;\n")
    other = _write(tmp_path / "other.cuh", "constexpr int kO = 1;\n")
    d0 = _build.source_digest(src)
    assert _build.source_digest(src) == d0
    other.write_text("constexpr int kO = 2;\n")
    assert _build.source_digest(src) == d0
    b.write_text("constexpr int kB = 2;\n")
    d1 = _build.source_digest(src)
    assert d1 != d0
    a.write_text(a.read_text() + "// note\n")
    d2 = _build.source_digest(src)
    assert d2 not in (d0, d1)
    src.write_text(src.read_text() + "// note\n")
    assert _build.source_digest(src) not in (d0, d1, d2)


def test_build_names_libraries_by_digest(monkeypatch, tmp_path):
    """``build`` looks for the library under the source's digest, and
    loads an existing one without nvcc."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    _write(csrc / "k.cu", '#include "h.cuh"\n')
    h = _write(csrc / "h.cuh", "// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    name = f"libk_{_build.source_digest(csrc / 'k.cu')[:16]}.so"
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / name).write_bytes(b"")
    lib, secs, _ = _build.build("k")
    assert lib.name == name and secs == 0.0
    h.write_text("// two\n")
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc here")))
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.build("k")
