"""Known splice sites: load a splicesites map IIT into sorted arrays.

Replaces the reference's splicetrie machinery for SITE LOOKUP
(Splicetrie_retrieve_via_splicesites, splicetrie_build.c:338): the
splicing IIT stores typed intervals ">label chr:X..Y donor|acceptor
[dist]" (README:848-888; 1-based, X from the donor exon, Y from the
acceptor exon; X<Y = plus strand, X>Y = minus).  The universal scan
coordinate used by solve_singlesplice equals Interval_low + chroffset
for every site class (the 1-based-exon / 0-based-intron shifts cancel),
so each class reduces to one sorted uint32 array and membership testing
is a searchsorted gather — no trie needed for interior splices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .iit import IIT


@dataclass
class SpliceSites:
    donors: np.ndarray         # sorted uint32 universal coords
    acceptors: np.ndarray
    antidonors: np.ndarray
    antiacceptors: np.ndarray
    max_dist: int              # largest annotated intron distance (0 if none)
    labels: dict | None = None  # universal coord -> site label
    # per-site observed intron distances, parallel to the coord arrays
    # (splicetrie_build.c:489-527: splicedists from the annotation
    # field; same-position duplicates keep the max).  Empty arrays when
    # distances_observed is False.
    donor_dists: np.ndarray | None = None
    acceptor_dists: np.ndarray | None = None
    antidonor_dists: np.ndarray | None = None
    antiacceptor_dists: np.ndarray | None = None
    distances_observed: bool = False
    # True when the sites were derived from an INTRONS-format file:
    # only the obs trie exists (gsnap.c:2214 triecontents_max = NULL),
    # so shortend partners beyond the observed distance are excluded
    # outright instead of penalized
    introns_only: bool = False

    def dists_for(self, arr: np.ndarray) -> np.ndarray | None:
        """The distance array parallel to one of the four coord arrays
        (identity match on the array object)."""
        for a, d in ((self.donors, self.donor_dists),
                     (self.acceptors, self.acceptor_dists),
                     (self.antidonors, self.antidonor_dists),
                     (self.antiacceptors, self.antiacceptor_dists)):
            if a is arr:
                return d
        return None

    @property
    def nsites(self) -> int:
        return (len(self.donors) + len(self.acceptors)
                + len(self.antidonors) + len(self.antiacceptors))

    def device_arrays(self):
        import jax.numpy as jnp

        return tuple(
            jnp.asarray(a)
            for a in (self.donors, self.acceptors, self.antidonors,
                      self.antiacceptors)
        )

    def device_bitmasks(self, genome_length: int):
        """Four genome-length bitvectors (uint32 words) — the device form
        consumed by the splice scan (cf. the reference's splicecomp
        bit-vector, splicetrie_build.c:464)."""
        import jax.numpy as jnp

        nwords = (genome_length + 31) // 32 + 2
        out = []
        for a in (self.donors, self.acceptors, self.antidonors,
                  self.antiacceptors):
            bits = np.zeros(nwords, np.uint32)
            if len(a):
                w = a >> 5
                np.bitwise_or.at(bits, w, np.uint32(1) << (a & 31))
            out.append(jnp.asarray(bits))
        return tuple(out)


def load_splicesites(iit: IIT, chr_names: list[str],
                     chr_starts: np.ndarray) -> SpliceSites:
    """Collect per-class sorted site coordinate arrays from a splicing
    IIT, keyed by division name -> chromosome offset."""
    offs = {name: int(chr_starts[i]) for i, name in enumerate(chr_names)}
    buckets: dict[str, dict[int, int]] = {
        "donors": {}, "acceptors": {}, "antidonors": {}, "antiacceptors": {}
    }
    labels: dict[int, str] = {}
    max_dist = 0
    distances_observed = None

    # file-type detection (gsnap.c:2157-2196): donor/acceptor TYPE tags
    # mean a splicesites file; none means an INTRONS file, whose sites
    # derive from the intron span ends (Splicetrie_retrieve_via_introns,
    # splicetrie_build.c:751-850: plus introns put a donor at low and an
    # acceptor at high-1; minus introns an antiacceptor at low and an
    # antidonor at high-1; distances = the intron lengths)
    has_tags = any(t in ("donor", "acceptor") for t in iit.types)
    if not has_tags:
        for div, ivs in iit.intervals.items():
            if div not in offs:
                continue
            chroffset = offs[div]
            labs = iit.labels.get(div, [])
            for i, iv in enumerate(ivs):
                dist = iv.high - iv.low + 1
                max_dist = max(max_dist, dist)
                lowpos = iv.low + chroffset
                highpos = iv.high - 1 + chroffset
                if iv.sign >= 0:
                    pairs = (("donors", lowpos), ("acceptors", highpos))
                else:
                    pairs = (("antiacceptors", lowpos),
                             ("antidonors", highpos))
                for key, pos in pairs:
                    prev = buckets[key].get(pos)
                    buckets[key][pos] = (dist if prev is None
                                         else max(prev, dist))
                    if i < len(labs):
                        labels.setdefault(pos, labs[i])

        def sorted_pair(key):
            pos = np.array(sorted(buckets[key]), np.uint32)
            dists = np.array(
                [buckets[key][p] for p in sorted(buckets[key])], np.uint32)
            return pos, dists

        dpos, dd = sorted_pair("donors")
        apos, ad = sorted_pair("acceptors")
        ndpos, ndd = sorted_pair("antidonors")
        napos, nad = sorted_pair("antiacceptors")
        return SpliceSites(
            donors=dpos, acceptors=apos, antidonors=ndpos,
            antiacceptors=napos, max_dist=max_dist, labels=labels,
            donor_dists=dd, acceptor_dists=ad,
            antidonor_dists=ndd, antiacceptor_dists=nad,
            distances_observed=True, introns_only=True,
        )

    for div, ivs in iit.intervals.items():
        if div not in offs:
            continue
        chroffset = offs[div]
        anns = iit.annotations.get(div, [])
        for i, iv in enumerate(ivs):
            typ = iit.types[iv.type]
            pos = iv.low + chroffset
            if typ == "donor":
                key = "donors" if iv.sign >= 0 else "antidonors"
            elif typ == "acceptor":
                key = "acceptors" if iv.sign >= 0 else "antiacceptors"
            else:
                continue
            labs = iit.labels.get(div, [])
            if i < len(labs):
                labels.setdefault(pos, labs[i])
            # distances_observed keys on the FIRST entry's annotation
            # (splicetrie_build.c:379-389)
            ann = anns[i].decode() if i < len(anns) and anns[i] else ""
            dist = None
            if ann.strip():
                try:
                    dist = int(ann.split()[0])
                except ValueError:
                    pass
            if distances_observed is None:
                distances_observed = dist is not None
            if dist is None:
                dist = 0
            max_dist = max(max_dist, dist)
            prev = buckets[key].get(pos)
            # same-position duplicates keep the max observed distance
            # (splicetrie_build.c:538-539)
            buckets[key][pos] = dist if prev is None else max(prev, dist)

    def sorted_pair(key):
        pos = np.array(sorted(buckets[key]), np.uint32)
        dists = np.array([buckets[key][p] for p in sorted(buckets[key])],
                         np.uint32)
        return pos, dists

    dpos, dd = sorted_pair("donors")
    apos, ad = sorted_pair("acceptors")
    ndpos, ndd = sorted_pair("antidonors")
    napos, nad = sorted_pair("antiacceptors")
    return SpliceSites(
        donors=dpos, acceptors=apos, antidonors=ndpos, antiacceptors=napos,
        max_dist=max_dist,
        labels=labels,
        donor_dists=dd, acceptor_dists=ad,
        antidonor_dists=ndd, antiacceptor_dists=nad,
        distances_observed=bool(distances_observed),
    )
