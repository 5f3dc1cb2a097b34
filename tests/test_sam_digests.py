"""Whole-program parity: the SAM of five deployment configs on a small
seeded database (chip_smoke.sam_digests) must hash to the digests in
sam_digests.json, which the CPU run of the code before the gather
rewrite produced.  chip_smoke.py holds the card to the same digests."""

import json

import pytest

import chip_smoke

CONFIGS = ["se", "pe", "pe_novelsplice", "known_splice_snp", "cmet_stranded"]


@pytest.fixture(scope="module")
def digests(tmp_path_factory):
    return chip_smoke.sam_digests(str(tmp_path_factory.mktemp("digest")))


@pytest.mark.parametrize("config", CONFIGS)
def test_sam_digest(digests, config):
    with open(chip_smoke.DIGEST_FILE) as f:
        want = json.load(f)
    assert sorted(want) == sorted(CONFIGS)
    assert digests[config] == want[config]
