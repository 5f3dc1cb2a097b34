"""GSNAP paired-end alignment: batched concordance pairing on device.

Re-designs the reference's paired-end flow (stage1hr.c:13724 align_pair
+ stage3hr.c:9745 Stage3_pair_up_concordant + stage3hr.c:5074
Stage3_determine_pairtype) as a dense pairing grid:

  * both ends run the full gapped single-end pipeline (read 2 is
    reverse-complemented at input like the reference's invert_second_p,
    so concordant mates align to the SAME strand);
  * the top hits per end form an [NP x NP] grid; each cell is classified
    by Stage3_determine_pairtype's exact rules (UNPAIRED across
    chromosomes; INVERSION on strand mismatch; SCRAMBLE / TOOLONG /
    CONCORDANT by genomic order and pairmax);
  * concordant pairs dominate: if any exist, pairs are ranked among them
    only; otherwise among the PAIRED classes (inversion/scramble/
    toolong) — mirroring the resulttype ladder CONCORDANT_* > PAIRED_* >
    UNPAIRED/HALFMAPPING/NOMAPPING (resulthr.h:7-12);
  * pair score = end scores summed; optimal-score filtering and
    deterministic (score, left5, left3) ranking happen on device.

Insert length follows the reference: concordant pairs use the outer
span hit3.genomicend - hit5.genomicstart (plus) / hit5.genomicstart -
hit3.genomicend (minus); PAIRED classes use the outer envelope.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import genome as genome_ops
from . import gsnap_gapped
from .gsnap_gapped import (
    BIG_NMM,
    KIND_DEL,
    KIND_INS,
    KIND_SHORTEXON,
    KIND_SPLICE,
    GappedParams,
)
from .gsnap_se import IndexArrays

# pairtypes (stage3hr.h Pairtype_T order)
PT_CONCORDANT = 0
PT_INVERSION = 1
PT_SCRAMBLE = 2
PT_TOOLONG = 3
PT_UNPAIRED = 4

PAIRMAX_DNA = 1_000        # gsnap.c:95 pairmax_dna
PAIRMAX_RNA = 200_000      # gsnap.c:96 pairmax_rna
EXPECTED_PAIRLENGTH = 200  # gsnap.c:97

BIG = jnp.int32(10**6)


@dataclass(frozen=True)
class PEParams:
    gapped: GappedParams = GappedParams()
    pairmax: int = PAIRMAX_DNA
    npair_end: int = 16    # per-end hits entering the pairing grid
    maxpairs: int = 100    # pairs reported


def _refspan(h, lengths):
    """Genome bases consumed by each hit (untrimmed)."""
    L = lengths[:, None]
    intron = (h["right"] - h["left"]).astype(jnp.int32)
    return jnp.where(
        h["kind"] == KIND_DEL, L + h["nindels"],
        jnp.where(h["kind"] == KIND_INS, L - h["nindels"],
                  jnp.where(h["kind"] == KIND_SPLICE, L + intron, L)),
    )


@partial(jax.jit, static_argnames=("params",))
def align_batch_pe(
    genome: genome_ops.GenomeArrays,
    index: IndexArrays,
    codes5, nflags5, lengths5,
    codes3, nflags3, lengths3,   # read 2 ALREADY reverse-complemented
    params: PEParams = PEParams(),
    index_minus: IndexArrays | None = None,
    alt=None,
    known=None,
):
    """Returns a dict with per-pair arrays [B, maxpairs] (fields i5/i3 =
    indices into the per-end hit dicts, pairtype, insert, pscore),
    npairs int32[B], plus the ranked per-end hit dicts under keys
    "end5"/"end3" (each the align_batch_gapped output for fallback
    halfmapping/unpaired emission)."""
    gp = params.gapped
    base = gp.base
    np_ = params.npair_end

    # both ends ride ONE [2B] cascade call (and, in standard mode, one
    # [4B] strand-stacked core inside): per-op fixed costs amortize and
    # every index/genome gather runs at double batch
    b_ = codes5.shape[0]
    out2, cands2 = gsnap_gapped.gather_candidates(
        genome, index, index_minus,
        jnp.concatenate([codes5, codes3]),
        jnp.concatenate([nflags5, nflags3]),
        jnp.concatenate([lengths5, lengths3]), gp, alt, known)
    out5 = {k: v[:b_] for k, v in out2.items()}
    out3 = {k: v[b_:] for k, v in out2.items()}
    cands5 = {k: v[:b_] for k, v in cands2.items()}
    cands3 = {k: v[b_:] for k, v in cands2.items()}

    # pairing uses per-end hits WITHOUT the per-end optimal filter: a
    # suboptimal end can form the optimal pair (reference keeps all hits
    # through Stage3_pair_up_concordant before Stage3pair_optimal_score)
    h5 = gsnap_gapped.rank_hits(out5, base, apply_optimal=False, maxout=np_)
    h3 = gsnap_gapped.rank_hits(out3, base, apply_optimal=False, maxout=np_)

    l5 = h5["left"].astype(jnp.int32)[:, :, None]       # [B, NP, 1]
    l3 = h3["left"].astype(jnp.int32)[:, None, :]       # [B, 1, NP]
    s5 = _refspan(h5, lengths5.astype(jnp.int32))[:, :, None]
    s3 = _refspan(h3, lengths3.astype(jnp.int32))[:, None, :]
    e5 = l5 + s5
    e3 = l3 + s3
    p5 = h5["plusp"][:, :, None]
    p3 = h3["plusp"][:, None, :]
    v5 = (h5["score"] < BIG_NMM)[:, :, None]
    v3 = (h3["score"] < BIG_NMM)[:, None, :]
    chr5 = jnp.searchsorted(genome.chr_offsets, h5["left"], side="right")[:, :, None]
    chr3 = jnp.searchsorted(genome.chr_offsets, h3["left"], side="right")[:, None, :]

    pairmax = jnp.int32(params.pairmax)
    # Stage3_determine_pairtype (stage3hr.c:5074); for plus hits
    # genomicstart = left, genomicend = left + span; minus hits reverse
    plus_scr = e3 < l5
    plus_long = l3 > e5 + pairmax
    minus_scr = l3 > e5
    minus_long = e3 + pairmax < l5
    pairtype = jnp.where(
        chr5 != chr3, PT_UNPAIRED,
        jnp.where(p5 != p3, PT_INVERSION,
                  jnp.where(p5,
                            jnp.where(plus_scr, PT_SCRAMBLE,
                                      jnp.where(plus_long, PT_TOOLONG, PT_CONCORDANT)),
                            jnp.where(minus_scr, PT_SCRAMBLE,
                                      jnp.where(minus_long, PT_TOOLONG, PT_CONCORDANT)))),
    )
    valid = v5 & v3

    insert_conc = jnp.where(p5, e3 - l5, e5 - l3)
    insert_outer = jnp.maximum(e5, e3) - jnp.minimum(l5, l3)
    insert = jnp.where(pairtype == PT_CONCORDANT, insert_conc, insert_outer)

    pscore = h5["score"][:, :, None] + h3["score"][:, None, :]

    # Stage3pair_new rejects "concordant" pairs whose insertlength
    # computes to 0 (stage3hr.c:7557: mate falls inside an intron /
    # beyond the hit end with no substring overlap).  Reproduce the
    # zero cases of pair_insert_length: no aligned-part overlap AND the
    # hit5 end beyond mate start by more than both read lengths.
    def _part_ivs(h, lengths):
        L = lengths.astype(jnp.int32)[:, None]
        kind = h["kind"]
        left = h["left"].astype(jnp.int32)
        right = h["right"].astype(jnp.int32)
        mid = h["mid"].astype(jnp.int32)
        split = h["split"]
        split2 = h["split2"]
        nind = h["nindels"]
        multi = ((kind == KIND_SPLICE) | (kind == KIND_DEL)
                 | (kind == KIND_INS) | (kind == KIND_SHORTEXON))
        lo1 = left
        hi1 = left + jnp.where(multi, split, L)
        lo2 = jnp.where(kind == KIND_SHORTEXON, mid + split,
                        jnp.where(kind == KIND_INS,
                                  right + split + nind, right + split))
        hi2 = jnp.where(kind == KIND_SHORTEXON, mid + split2, right + L)
        ok2 = multi
        lo3 = right + split2
        hi3 = right + L
        ok3 = kind == KIND_SHORTEXON
        los = jnp.stack([lo1, lo2, lo3], axis=-1)
        his = jnp.stack([hi1, hi2, hi3], axis=-1)
        oks = jnp.stack([jnp.ones_like(ok2), ok2, ok3], axis=-1)
        return los, his, oks

    lo5p, hi5p, ok5p = _part_ivs(h5, lengths5)
    lo3p, hi3p, ok3p = _part_ivs(h3, lengths3)
    # [B, NP5, NP3, 3, 3] part-pair overlap, reduced
    a_lo = lo5p[:, :, None, :, None]
    a_hi = hi5p[:, :, None, :, None]
    a_ok = ok5p[:, :, None, :, None]
    b_lo = lo3p[:, None, :, None, :]
    b_hi = hi3p[:, None, :, None, :]
    b_ok = ok3p[:, None, :, None, :]
    part_overlap = jnp.any(
        a_ok & b_ok & ~((b_hi < a_lo) | (b_lo > a_hi)), axis=(3, 4))
    q = (lengths5.astype(jnp.int32)[:, None]
         + lengths3.astype(jnp.int32)[:, None])[:, :, None]
    insert0 = ~part_overlap & jnp.where(
        p5, e5 > l3 + q, e3 > l5 + q)

    conc = valid & (pairtype == PT_CONCORDANT) & ~insert0
    paired = valid & (
        (pairtype == PT_INVERSION) | (pairtype == PT_SCRAMBLE)
        | (pairtype == PT_TOOLONG)
    )
    have_conc = jnp.any(conc, axis=(1, 2), keepdims=True)
    chosen = jnp.where(have_conc, conc, paired)
    eff = jnp.where(chosen, pscore, BIG)

    b = eff.shape[0]
    eff = eff.reshape(b, np_ * np_)
    # pair-level optimal-score filter (Stage3pair_optimal_score,
    # stage3hr.c:9719)
    best = jnp.min(eff, axis=1, keepdims=True)
    eff = jnp.where(eff > best + base.subopt_levels, BIG, eff)

    take_cols = lambda x, i: jnp.take_along_axis(x, i, axis=1)
    flat = lambda x: jnp.broadcast_to(x, (b, np_, np_)).reshape(b, np_ * np_)
    left5f = flat(l5)
    left3f = flat(l3)
    # rank: (score, left5, left3); compose the passes into one
    # permutation
    o1 = jnp.argsort(left3f, axis=1, stable=True)
    o2 = jnp.argsort(take_cols(left5f, o1), axis=1, stable=True)
    perm = take_cols(o1, o2)
    o3 = jnp.argsort(take_cols(eff, perm), axis=1, stable=True)[:, : params.maxpairs]
    idx = take_cols(perm, o3)
    eff2 = take_cols(eff, idx)

    ok = eff2 < BIG
    i5 = idx // np_
    i3 = idx % np_
    ptf = take_cols(
        jnp.broadcast_to(pairtype, (b, np_, np_)).reshape(b, -1), idx)
    insf = take_cols(
        jnp.broadcast_to(insert, (b, np_, np_)).reshape(b, -1), idx)

    # candidate-budget overflow gate, pair form (see align_batch_gapped):
    # for a CONCORDANT pair the host rescue lanes never run (run_pe
    # need_full tests only pairing outcomes), so a dropped diagonal can
    # only matter through the device solvers — as a SUB end of a pair
    # that reaches the best pair score (bounded by ovf_bound + the
    # mate's best) or as a middle-indel piece (possible only when the
    # end's score budget reaches the indel penalty).  novelsplicing /
    # known-splice runs keep the rescue unconditionally.
    if known is None:
        npairs_ = jnp.sum(ok, axis=1).astype(jnp.int32)
        conc_ok = have_conc[:, 0, 0] & (npairs_ > 0)
        so = base.subopt_levels
        pbest = eff2[:, 0]
        s5b = h5["score"][:, 0]
        s3b = h3["score"][:, 0]
        b5 = cands5["ovf_bound"]
        b3 = cands3["ovf_bound"]
        sub_ok = ((b5 + s3b > pbest + so) & (b3 + s5b > pbest + so)
                  & (b5 + b3 > pbest + so))
        # an indel end from a dropped diagonal needs that end's score
        # allocation to reach the indel penalty AND a dropped diagonal
        # able to serve as an indel side — the per-half floor bound
        # (hbound, see gsnap_gapped) rules out any side spanning >= a
        # half of the read
        alloc5 = pbest + so - s3b
        alloc3 = pbest + so - s5b
        hb5 = cands5["hbound"]
        hb3 = cands3["hbound"]
        ind_ok = (((alloc5 < base.indel_penalty_middle) | (hb5 > alloc5))
                  & ((alloc3 < base.indel_penalty_middle)
                     | (hb3 > alloc3)))
        if gp.novelsplicing:
            # novel splice sides enter at localsplicing_penalty (0):
            # require the half floor to exceed the full allocation
            ind_ok = ind_ok & (hb5 > alloc5) & (hb3 > alloc3)
        safe = conc_ok & sub_ok & ind_ok
        for c in (cands5, cands3):
            # floor bound only covers top-ncand drops, not truncation
            c["overflow"] = c["overflow"] & ~(safe & ~c["overflow_trunc"])
    cands5.pop("ovf_bound")
    cands3.pop("ovf_bound")
    cands5.pop("hbound", None)
    cands3.pop("hbound", None)

    return {
        "i5": jnp.where(ok, i5, 0),
        "i3": jnp.where(ok, i3, 0),
        "pairtype": jnp.where(ok, ptf, PT_UNPAIRED),
        "insert": jnp.where(ok, insf, 0),
        "pscore": jnp.where(ok, eff2, BIG),
        "npairs": jnp.sum(ok, axis=1).astype(jnp.int32),
        "pair_concordant": have_conc[:, 0, 0],
        "end5": gsnap_gapped.rank_hits(out5, base),
        "end3": gsnap_gapped.rank_hits(out3, base),
        "end5_pairing": h5,
        "end3_pairing": h3,
        "cands5": cands5,
        "cands3": cands3,
    }


# the per-end hit fields SAM emission reads through _end_hit
PAIR_EMIT_FIELDS = ("kind", "left", "right", "split", "nindels",
                    "sense", "plusp", "mid", "split2")


@partial(jax.jit, static_argnames=("ktop",))
def compact_pe(res, ktop: int = 8):
    """Emission-compact view of an align_batch_pe result.

    Transfer-volume design: the full result tree is ~6.5 MB per 256-pair
    batch, but the SAM success path reads only the top-ranked pairs'
    hit fields.  This gathers those into [B, ktop] arrays (~0.2 MB);
    the full tree stays ON DEVICE and rows that need rescue lanes
    (non-concordant / unmapped / npairs > ktop) are fetched later as a
    row subset (runner.fetch_pair_rows)."""
    from .gsnap_gapped import _slim

    i5 = res["i5"][:, :ktop]
    i3 = res["i3"][:, :ktop]
    top5 = _slim({k: jnp.take_along_axis(res["end5_pairing"][k], i5, axis=1)
                  for k in PAIR_EMIT_FIELDS})
    top3 = _slim({k: jnp.take_along_axis(res["end3_pairing"][k], i3, axis=1)
                  for k in PAIR_EMIT_FIELDS})
    b = i5.shape[0]
    ar = jnp.broadcast_to(
        jnp.arange(ktop, dtype=res["i5"].dtype)[None, :], (b, ktop))
    return {
        "npairs": res["npairs"],
        # per-end hit counts let fetch_pair_rows decide whether the
        # maxpaths-wide end-hit columns can be sliced before transfer
        "np5": res["end5"]["npaths"],
        "np3": res["end3"]["npaths"],
        "pair_concordant": res["pair_concordant"],
        "pairtype": res["pairtype"][:, :ktop].astype(jnp.uint8),
        "insert": res["insert"][:, :ktop],
        "pscore": res["pscore"][:, :ktop],
        "i5": ar,
        "i3": ar,
        "end5_pairing": top5,
        "end3_pairing": top3,
        "end5": {"overflow": res["cands5"]["overflow"],
                 "overflow_trunc": res["cands5"]["overflow_trunc"]},
        "end3": {"overflow": res["cands3"]["overflow"],
                 "overflow_trunc": res["cands3"]["overflow_trunc"]},
    }
