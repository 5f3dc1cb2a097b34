/* genome_hr.c — re-derived implementation of the genome_hr interface.
 *
 * The reference snapshot (genome-vendor/gmap-gsnap 2012-07-03) lists
 * genome_hr.c in its build (src/Makefile.am:17) but the file is absent.
 * This implementation re-derives the semantics from genome_hr.h and the
 * call sites (stage1hr.c, substring.c, splicetrie.c, stage2.c, indexdb.c)
 * so the reference binaries can be BUILT and used as a golden-output
 * oracle for the framework's parity tests.  It is intentionally
 * scalar and simple (one genome character at a time) — correctness over
 * speed; it is NOT part of the shipped framework.
 *
 * Validation: gmap built with this file reproduces tests/align.test.ok
 * and tests/map.test.ok byte-exactly.
 */

#ifdef HAVE_CONFIG_H
#include <config.h>
#endif
#include "genome_hr.h"
#include "compress.h"
#include "mode.h"
#include <ctype.h>
#include <stdio.h>
#include <stdlib.h>

#define MAXREAD 1000

static UINT4 *ref_blocks = NULL;
static UINT4 *snp_blocks = NULL;
static bool query_unk_mismatch_p = false;
static bool genome_unk_mismatch_p = true;
static Mode_T mode = STANDARD;

void
Genome_hr_setup (UINT4 *ref_blocks_in, UINT4 *snp_blocks_in,
		 bool query_unk_mismatch_p_in, bool genome_unk_mismatch_p_in,
		 Mode_T mode_in) {
  ref_blocks = ref_blocks_in;
  snp_blocks = snp_blocks_in;
  query_unk_mismatch_p = query_unk_mismatch_p_in;
  genome_unk_mismatch_p = genome_unk_mismatch_p_in;
  mode = mode_in;
  return;
}

void
Genome_hr_user_setup (UINT4 *ref_blocks_in,
		      bool query_unk_mismatch_p_in, bool genome_unk_mismatch_p_in,
		      Mode_T mode_in) {
  ref_blocks = ref_blocks_in;
  snp_blocks = NULL;
  query_unk_mismatch_p = query_unk_mismatch_p_in;
  genome_unk_mismatch_p = genome_unk_mismatch_p_in;
  mode = mode_in;
  return;
}

/************************************************************************
 * Block access.  Layout per 32-nt block (see compress.c): 3 UINT4 words
 * [high, low, flags]; low = nt 0..15 LSB-first 2 bits each, high =
 * nt 16..31, flag bit i => nt i is non-ACGT.
 ************************************************************************/

static inline int
block_code (UINT4 *blocks, Genomicpos_T pos) {
  Genomicpos_T b = pos/32U*3U;
  int r = pos % 32;
  UINT4 w = (r < 16) ? blocks[b+1] : blocks[b];
  return (int) ((w >> (2*(r & 15))) & 3U);
}

static inline int
block_flag (UINT4 *blocks, Genomicpos_T pos) {
  Genomicpos_T b = pos/32U*3U;
  int r = pos % 32;
  return (int) ((blocks[b+2] >> r) & 1U);
}

/* mode conversion applied to both query and genome codes before compare */
static inline int
convert_code (int code, bool plusp, int genestrand) {
  bool forward;
  switch (mode) {
  case STANDARD: return code;
  case CMET_STRANDED:
    forward = plusp;
    break;
  case CMET_NONSTRANDED:
    forward = (genestrand >= 0) ? plusp : !plusp;
    break;
  case ATOI_STRANDED:
    forward = plusp;
    if (genestrand >= 0 ? plusp : !plusp) {
      return (code == 0) ? 2 : code;	/* A -> G */
    } else {
      return (code == 3) ? 1 : code;	/* T -> C */
    }
  case ATOI_NONSTRANDED:
    if (genestrand >= 0 ? plusp : !plusp) {
      return (code == 0) ? 2 : code;
    } else {
      return (code == 3) ? 1 : code;
    }
  default: return code;
  }
  /* CMET */
  if (forward) {
    return (code == 1) ? 3 : code;	/* C -> T */
  } else {
    return (code == 2) ? 0 : code;	/* G -> A */
  }
}

/* Is query position qpos (in the query_compress coordinate system) a
   mismatch vs plus-strand genome position gpos?  Checks ref and, when
   present, the SNP-substituted alt genome: a position matching either
   is not a mismatch. */
static inline bool
mismatch_at (UINT4 *qblocks, int qpos, Genomicpos_T gpos, bool plusp, int genestrand,
	     bool use_alt) {
  int qc, gc;
  if (block_flag(qblocks, (Genomicpos_T) qpos)) {
    return query_unk_mismatch_p;
  }
  qc = convert_code(block_code(qblocks, (Genomicpos_T) qpos), plusp, genestrand);
  if (!block_flag(ref_blocks, gpos)) {
    gc = convert_code(block_code(ref_blocks, gpos), plusp, genestrand);
    if (qc == gc) {
      return false;
    }
  } else if (genome_unk_mismatch_p == false) {
    return false;
  }
  if (use_alt && snp_blocks != NULL) {
    /* alt-genome flags mark SNP positions (snpindex substitutions), not
       Ns — compare codes regardless of the flag */
    gc = convert_code(block_code(snp_blocks, gpos), plusp, genestrand);
    if (qc == gc) {
      return false;
    }
  }
  return true;
}

/************************************************************************
 * Gamma decoding for the compressed offsets (indexdb).  The writer
 * (indexdb.c:1914-1975 write_gamma) packs Elias-gamma codes of
 * (delta+1) MSB-first into 32-bit words.  ctr = bits already consumed
 * from the current word.
 ************************************************************************/

int
Genome_read_gamma (unsigned int **ptr, int ctr, unsigned int *cum) {
  unsigned int value = 0;
  int zeros = 0, i;

  while ((((**ptr) >> (31 - ctr)) & 1U) == 0U) {
    zeros++;
    if (++ctr == 32) { (*ptr)++; ctr = 0; }
  }
  for (i = 0; i <= zeros; i++) {
    value = (value << 1) | (((**ptr) >> (31 - ctr)) & 1U);
    if (++ctr == 32) { (*ptr)++; ctr = 0; }
  }
  *cum += value - 1U;
  return ctr;
}

Positionsptr_T
Genome_offsetptr_from_gammas (Positionsptr_T *end0, UINT4 *gammaptrs, Positionsptr_T *offsetscomp,
			      unsigned int offsets_blocksize, Storedoligomer_T oligo) {
  unsigned int *ptr;
  int ctr = 0;
  unsigned int k, j;
  Positionsptr_T cum, start;

  if (offsets_blocksize == 1) {
    /* flat offsets: no gammaptrs file (basesize == kmer) */
    *end0 = offsetscomp[oligo + 1];
    return offsetscomp[oligo];
  }

  k = oligo / offsets_blocksize;
  j = oligo % offsets_blocksize;
  ptr = &(offsetscomp[gammaptrs[k]]);
  cum = *ptr++;
  for (k = 0; k < j; k++) {
    ctr = Genome_read_gamma(&ptr, ctr, &cum);
  }
  start = cum;
  if (j == offsets_blocksize - 1) {
    *end0 = offsetscomp[gammaptrs[oligo / offsets_blocksize + 1]];
  } else {
    ctr = Genome_read_gamma(&ptr, ctr, &cum);
    *end0 = cum;
  }
  return start;
}

Positionsptr_T
Genome_offsetptr_only_from_gammas (UINT4 *gammaptrs, Positionsptr_T *offsetscomp,
				   unsigned int offsets_blocksize, Storedoligomer_T oligo) {
  unsigned int *ptr;
  int ctr = 0;
  unsigned int k, j;
  Positionsptr_T cum;

  if (offsets_blocksize == 1) {
    return offsetscomp[oligo];
  }

  k = oligo / offsets_blocksize;
  j = oligo % offsets_blocksize;
  ptr = &(offsetscomp[gammaptrs[k]]);
  cum = *ptr++;
  for (k = 0; k < j; k++) {
    ctr = Genome_read_gamma(&ptr, ctr, &cum);
  }
  return cum;
}

/************************************************************************
 * Mismatch counting
 ************************************************************************/

int
Genome_count_mismatches (Compress_T query_compress, Genomicpos_T left, Genomicpos_T left_plus_length) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;
  int length = (int) (left_plus_length - left);

  for (pos = 0; pos < length; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, /*plusp*/true, /*genestrand*/0, /*use_alt*/true)) {
      n++;
    }
  }
  return n;
}

int
Genome_count_mismatches_limit (Compress_T query_compress, Genomicpos_T left, int pos5, int pos3,
			       int max_mismatches, bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, /*use_alt*/true)) {
      if (++n > max_mismatches) {
	return n;
      }
    }
  }
  return n;
}

int
Genome_count_mismatches_substring_ref (Compress_T query_compress, Genomicpos_T left, int pos5, int pos3,
				       bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, /*use_alt*/false)) {
      n++;
    }
  }
  return n;
}

int
Genome_count_mismatches_substring (Compress_T query_compress, Genomicpos_T left, int pos5, int pos3,
				   bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, /*use_alt*/true)) {
      n++;
    }
  }
  return n;
}

/************************************************************************
 * 16-nt fragment compare (for splicetrie).  The fragment convention
 * follows splicetrie_build.c: splicefrags are 16-nt sequences packed
 * 2 bits per nt with the LAST nt in the low bits ("right-justified").
 * Genome_query_shift_fragment_right/left pack query[pos5..pos3) the
 * same way and return a mask covering the fragment lanes.
 ************************************************************************/

static UINT4
query_fragment (UINT4 *flags, UINT4 *mask, Compress_T query_compress, int pos5, int pos3,
		bool right_justify) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  UINT4 frag = 0U, fl = 0U;
  int length = pos3 - pos5;
  int i, pos;

  for (pos = pos5; pos < pos3; pos++) {
    frag = (frag << 2) | (UINT4) block_code(qblocks, (Genomicpos_T) pos);
    fl = (fl << 2) | (block_flag(qblocks, (Genomicpos_T) pos) ? 3U : 0U);
  }
  if (right_justify) {
    *mask = (length >= 16) ? 0xFFFFFFFFU : ((1U << (2*length)) - 1U);
  } else {
    /* left-justify: fragment occupies the high lanes */
    frag <<= 2*(16 - length);
    fl <<= 2*(16 - length);
    *mask = (length >= 16) ? 0xFFFFFFFFU : ~((1U << (2*(16 - length))) - 1U);
  }
  *flags = fl;
  (void) i;
  return frag;
}

UINT4
Genome_query_shift_fragment_right (UINT4 *flags, UINT4 *mask, Compress_T query_compress, int pos5, int pos3) {
  return query_fragment(flags, mask, query_compress, pos5, pos3, /*right_justify*/true);
}

UINT4
Genome_query_shift_fragment_left (UINT4 *flags, UINT4 *mask, Compress_T query_compress, int pos5, int pos3) {
  return query_fragment(flags, mask, query_compress, pos5, pos3, /*left_justify -> right?*/false);
}

int
Genome_count_mismatches_fragment (UINT4 query_shifted, UINT4 flags, UINT4 mask,
				  UINT4 ref_fragment, UINT4 alt_fragment) {
  UINT4 diff_ref, diff_alt, diff;
  int n = 0, i;

  diff_ref = (query_shifted ^ ref_fragment) & mask;
  diff_alt = (query_shifted ^ alt_fragment) & mask;
  if (query_unk_mismatch_p == false) {
    diff_ref &= ~flags;
    diff_alt &= ~flags;
  } else {
    diff_ref |= (flags & mask);
    diff_alt |= (flags & mask);
  }
  /* mismatch only if it differs from both ref and alt */
  diff = diff_ref & diff_alt;
  for (i = 0; i < 16; i++) {
    if ((diff >> (2*i)) & 3U) {
      n++;
    }
  }
  return n;
}

/************************************************************************
 * Mismatch position enumeration
 ************************************************************************/

int
Genome_mismatches_left (int *mismatch_positions, int max_mismatches, Compress_T query_compress,
			Genomicpos_T left, int pos5, int pos3, bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, /*use_alt*/true)) {
      mismatch_positions[n++] = pos;
      if (n > max_mismatches) {
	return n;
      }
    }
  }
  return n;
}

int
Genome_mismatches_right (int *mismatch_positions, int max_mismatches, Compress_T query_compress,
			 Genomicpos_T left, int pos5, int pos3, bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos;

  for (pos = pos3 - 1; pos >= pos5; pos--) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, /*use_alt*/true)) {
      mismatch_positions[n++] = pos;
      if (n > max_mismatches) {
	return n;
      }
    }
  }
  return n;
}

/************************************************************************
 * Mark mismatches into a genomic text buffer (for GSNAP output).
 * For plus-strand hits the buffer is in query coordinates: buffer index
 * = query position + mismatch_offset.  For minus-strand hits the buffer
 * holds the reverse-complemented segment in the READ's original
 * orientation, so the query_compress_rev coordinate pos mirrors to
 * read coordinate querylength-1-pos (verified against the genomic-
 * segment lowercase marks in gsnap's native output format).
 ************************************************************************/

static int
mark_mismatches (char *genomic, int querylength, Compress_T query_compress,
		 Genomicpos_T left, int pos5, int pos3, int mismatch_offset,
		 bool plusp, int genestrand, bool use_alt) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int n = 0, pos, idx;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, use_alt)) {
      if (plusp) {
	idx = pos + mismatch_offset;
      } else {
	idx = (querylength - 1 - pos) + mismatch_offset;
      }
      genomic[idx] = (char) tolower((int) genomic[idx]);
      n++;
    }
  }
  return n;
}

int
Genome_mark_mismatches_ref (char *genomic, int querylength, Compress_T query_compress,
			    Genomicpos_T left, int pos5, int pos3, int mismatch_offset,
			    bool plusp, int genestrand) {
  return mark_mismatches(genomic, querylength, query_compress, left, pos5, pos3,
			 mismatch_offset, plusp, genestrand, /*use_alt*/false);
}

int
Genome_mark_mismatches (char *genomic, int querylength, Compress_T query_compress,
			Genomicpos_T left, int pos5, int pos3, int mismatch_offset,
			bool plusp, int genestrand) {
  return mark_mismatches(genomic, querylength, query_compress, left, pos5, pos3,
			 mismatch_offset, plusp, genestrand, /*use_alt*/true);
}

/************************************************************************
 * Trimming (declared in genome_hr.h; no callers in this snapshot —
 * substring.c implements its own trim via Genome_mismatches_left/right)
 ************************************************************************/

int
Genome_trim_left (Compress_T query_compress, Genomicpos_T left, int pos5, int pos3,
		  bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int bestscore = 0, score = 0, trimpos = pos3, pos;

  for (pos = pos3 - 1; pos >= pos5; pos--) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, true)) {
      score -= 3;
    } else {
      score += 1;
    }
    if (score >= bestscore) {
      bestscore = score;
      trimpos = pos;
    }
  }
  return trimpos;
}

int
Genome_trim_right (Compress_T query_compress, Genomicpos_T left, int pos5, int pos3,
		   bool plusp, int genestrand) {
  UINT4 *qblocks = Compress_shift(query_compress, 0);
  int bestscore = 0, score = 0, trimpos = pos5, pos;

  for (pos = pos5; pos < pos3; pos++) {
    if (mismatch_at(qblocks, pos, left + pos, plusp, genestrand, true)) {
      score -= 3;
    } else {
      score += 1;
    }
    if (score >= bestscore) {
      bestscore = score;
      trimpos = pos;
    }
  }
  return trimpos;
}

/************************************************************************
 * Splice-site dinucleotide scans.  Conventions (matching the Maxent_hr
 * window anchors, maxent_hr.c:27218-27395):
 *   donor at pos:         GT at genome[pos], genome[pos+1]
 *   acceptor at pos:      AG at genome[pos-2], genome[pos-1]
 *   antidonor at pos:     AC at genome[pos-2], genome[pos-1]
 *   antiacceptor at pos:  CT at genome[pos], genome[pos+1]
 ************************************************************************/

static inline bool
dinucl_at (Genomicpos_T pos, int c1, int c2) {
  if (block_flag(ref_blocks, pos) || block_flag(ref_blocks, pos+1)) {
    return false;
  }
  return block_code(ref_blocks, pos) == c1 && block_code(ref_blocks, pos+1) == c2;
}

/* A=0 C=1 G=2 T=3 */
static inline bool donor_site_p (Genomicpos_T pos)        { return dinucl_at(pos, 2, 3); }      /* GT */
static inline bool acceptor_site_p (Genomicpos_T pos)     { return pos >= 2 && dinucl_at(pos-2, 0, 2); } /* AG */
static inline bool antidonor_site_p (Genomicpos_T pos)    { return pos >= 2 && dinucl_at(pos-2, 0, 1); } /* AC */
static inline bool antiacceptor_site_p (Genomicpos_T pos) { return dinucl_at(pos, 1, 3); }      /* CT */

typedef bool (*Sitep_T) (Genomicpos_T);

static int
site_positions (int *site_positions_out, int *site_knowni_out, int *knownpos, int *knowni,
		Genomicpos_T left, int pos5, int pos3, Sitep_T sitep) {
  int n = 0, pos, k = 0;

  for (pos = pos5; pos <= pos3; pos++) {
    while (knownpos[k] < pos) {
      k++;
    }
    if (knownpos[k] == pos) {
      site_positions_out[n] = pos;
      site_knowni_out[n++] = knowni[k];
      k++;
    } else if (sitep(left + (Genomicpos_T) pos)) {
      site_positions_out[n] = pos;
      site_knowni_out[n++] = -1;
    }
  }
  return n;
}

int
Genome_donor_positions (int *site_positions_out, int *site_knowni_out, int *knownpos, int *knowni,
			Genomicpos_T left, int pos5, int pos3) {
  return site_positions(site_positions_out, site_knowni_out, knownpos, knowni, left, pos5, pos3, donor_site_p);
}

int
Genome_acceptor_positions (int *site_positions_out, int *site_knowni_out, int *knownpos, int *knowni,
			   Genomicpos_T left, int pos5, int pos3) {
  return site_positions(site_positions_out, site_knowni_out, knownpos, knowni, left, pos5, pos3, acceptor_site_p);
}

int
Genome_antidonor_positions (int *site_positions_out, int *site_knowni_out, int *knownpos, int *knowni,
			    Genomicpos_T left, int pos5, int pos3) {
  return site_positions(site_positions_out, site_knowni_out, knownpos, knowni, left, pos5, pos3, antidonor_site_p);
}

int
Genome_antiacceptor_positions (int *site_positions_out, int *site_knowni_out, int *knownpos, int *knowni,
			       Genomicpos_T left, int pos5, int pos3) {
  return site_positions(site_positions_out, site_knowni_out, knownpos, knowni, left, pos5, pos3, antiacceptor_site_p);
}

/************************************************************************
 * Local-coordinate scans for GMAP stage2 shifted-canonical splicing
 * (only exercised with --cross-species).  Local coordinate conventions
 * per stage2.c find_canonical_dinucleotides / Oligoindex_hr debug
 * output: plus local i <-> global genomicstart + i; minus local i <->
 * global genomicend - 1 - i with complemented nucleotides, where
 * genomicend = genomicstart + genomiclength.
 *
 * lastGT[pos]: last local position p <= pos with (local) G,T at p+1,p+2
 * lastAG[pos]: last local position p <= pos with A,G at p-2,p-1
 * lastAC[pos]: like lastAG for A,C;   lastCT[pos]: like lastGT for C,T
 ************************************************************************/

static inline int
local_code (Genomicpos_T genomicstart, int genomiclength, bool plusp, int i) {
  if (plusp) {
    return block_code(ref_blocks, genomicstart + (Genomicpos_T) i);
  } else {
    return 3 - block_code(ref_blocks, genomicstart + (Genomicpos_T) (genomiclength - 1 - i));
  }
}

static inline bool
local_flag (Genomicpos_T genomicstart, int genomiclength, bool plusp, int i) {
  if (plusp) {
    return block_flag(ref_blocks, genomicstart + (Genomicpos_T) i) != 0;
  } else {
    return block_flag(ref_blocks, genomicstart + (Genomicpos_T) (genomiclength - 1 - i)) != 0;
  }
}

static void
last_positions (int *last_position, Genomicpos_T genomicstart, int margin5, int margin3,
		int genomiclength, bool plusp, int c1, int c2, bool leftanchor) {
  /* leftanchor: record position pos when dinucl at pos+1,pos+2 (GT/CT);
     else record pos+3 when dinucl at pos+1,pos+2 (AG/AC). */
  int pos, last = -1;

  (void) margin5; (void) margin3;
  for (pos = 0; pos <= genomiclength; pos++) {
    last_position[pos] = -1;
  }
  for (pos = 1; pos <= genomiclength - 4; pos++) {
    if (!local_flag(genomicstart, genomiclength, plusp, pos+1) &&
	!local_flag(genomicstart, genomiclength, plusp, pos+2) &&
	local_code(genomicstart, genomiclength, plusp, pos+1) == c1 &&
	local_code(genomicstart, genomiclength, plusp, pos+2) == c2) {
      last = leftanchor ? pos : pos + 3;
    }
    if (leftanchor) {
      last_position[pos] = last;
    } else if (pos + 3 <= genomiclength) {
      last_position[pos+3] = last;
    }
  }
  /* fill tail */
  for (pos = genomiclength - 3 > 0 ? genomiclength - 3 : 0; pos <= genomiclength; pos++) {
    if (last_position[pos] == -1 && pos > 0 && last_position[pos-1] != -1) {
      last_position[pos] = last_position[pos-1];
    }
  }
}

void
Genome_last_donor_positions (int *last_position, Genomicpos_T genomicstart, int margin5, int margin3,
			     int genomiclength, bool plusp) {
  last_positions(last_position, genomicstart, margin5, margin3, genomiclength, plusp, 2, 3, true);  /* GT */
}

void
Genome_last_acceptor_positions (int *last_position, Genomicpos_T genomicstart, int margin5, int margin3,
				int genomiclength, bool plusp) {
  last_positions(last_position, genomicstart, margin5, margin3, genomiclength, plusp, 0, 2, false); /* AG */
}

void
Genome_last_antidonor_positions (int *last_position, Genomicpos_T genomicstart, int margin5, int margin3,
				 int genomiclength, bool plusp) {
  last_positions(last_position, genomicstart, margin5, margin3, genomiclength, plusp, 0, 1, false); /* AC */
}

void
Genome_last_antiacceptor_positions (int *last_position, Genomicpos_T genomicstart, int margin5, int margin3,
				    int genomiclength, bool plusp) {
  last_positions(last_position, genomicstart, margin5, margin3, genomiclength, plusp, 1, 3, true);  /* CT */
}

static int
prev_position (int pos, Genomicpos_T genomicstart, Genomicpos_T genomicend, int pos5, bool plusp,
	       int c1, int c2, bool leftanchor) {
  int genomiclength = (int) (genomicend - genomicstart);
  int p;

  for (p = pos; p >= pos5; p--) {
    if (leftanchor) {
      if (p + 2 < genomiclength &&
	  !local_flag(genomicstart, genomiclength, plusp, p+1) &&
	  !local_flag(genomicstart, genomiclength, plusp, p+2) &&
	  local_code(genomicstart, genomiclength, plusp, p+1) == c1 &&
	  local_code(genomicstart, genomiclength, plusp, p+2) == c2) {
	return p;
      }
    } else {
      if (p - 2 >= 1 &&
	  !local_flag(genomicstart, genomiclength, plusp, p-2) &&
	  !local_flag(genomicstart, genomiclength, plusp, p-1) &&
	  local_code(genomicstart, genomiclength, plusp, p-2) == c1 &&
	  local_code(genomicstart, genomiclength, plusp, p-1) == c2) {
	return p;
      }
    }
  }
  return -1;
}

int
Genome_prev_donor_position (int pos, Genomicpos_T genomicstart, Genomicpos_T genomicend, int pos5, bool plusp) {
  return prev_position(pos, genomicstart, genomicend, pos5, plusp, 2, 3, true);
}

int
Genome_prev_acceptor_position (int pos, Genomicpos_T genomicstart, Genomicpos_T genomicend, int pos5, bool plusp) {
  return prev_position(pos, genomicstart, genomicend, pos5, plusp, 0, 2, false);
}

int
Genome_prev_antidonor_position (int pos, Genomicpos_T genomicstart, Genomicpos_T genomicend, int pos5, bool plusp) {
  return prev_position(pos, genomicstart, genomicend, pos5, plusp, 0, 1, false);
}

int
Genome_prev_antiacceptor_position (int pos, Genomicpos_T genomicstart, Genomicpos_T genomicend, int pos5, bool plusp) {
  return prev_position(pos, genomicstart, genomicend, pos5, plusp, 1, 3, true);
}

/************************************************************************
 * Dinucleotide at a position (declared in header; no callers found)
 ************************************************************************/

char
Genome_get_dinucleotide (char *altdinucl, Genomicpos_T pos) {
  static const char bases[4] = {'A','C','G','T'};
  altdinucl[0] = bases[block_code(ref_blocks, pos)];
  altdinucl[1] = bases[block_code(ref_blocks, pos+1)];
  altdinucl[2] = '\0';
  return altdinucl[0];
}
