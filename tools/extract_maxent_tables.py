"""Extract MaxEnt splice-model probability tables from the reference
maxent_hr.c into a binary .npz data file.

The tables are numeric model constants (maximum-entropy splice-site models
of Yeo & Burge 2004, as shipped in GMAP's maxent_hr.c); they are extracted
as *data* so that splice-site probabilities match the reference bit-for-bit.

Run once:  python tools/extract_maxent_tables.py
Writes:    gmap_gsnap/data/maxent_hr_tables.npz
"""
import re
import numpy as np

SRC = "/root/reference/src/maxent_hr.c"
OUT = "gmap_gsnap/data/maxent_hr_tables.npz"

NAMES = [
    "donor_score_plus", "donor_discore_plus",
    "acc_score1_plus", "acc_score2_plus", "acc_score3_plus",
    "acc_discore_plus", "acc_score467_plus", "acc_score589_plus",
    "donor_score_minus", "donor_discore_minus",
    "acc_score1_minus", "acc_score2_minus", "acc_score3_minus",
    "acc_discore_minus", "acc_score467_minus", "acc_score589_minus",
]

text = open(SRC).read()
tables = {}
for name in NAMES:
    m = re.search(
        r"static const double " + name + r"\[\d+\] =\s*\{(.*?)\};", text, re.S
    )
    assert m, name
    vals = [float(x) for x in re.findall(r"[-+0-9.eE]+", m.group(1))]
    tables[name] = np.asarray(vals, dtype=np.float64)
    print(name, len(vals))

assert all(len(tables[n]) in (16, 16384) for n in NAMES)
np.savez_compressed(OUT, **tables)
print("wrote", OUT)
