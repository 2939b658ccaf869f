"""Time K5 (``csrc/fd_rows.cu``) between source trees of the port on the
card, in one call.

    python tools/torch_k5_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` into a directory ``.gitignore`` lists, and ``.``); name the
trees in an order that alternates them (``_parent . . _parent``). Each tree
runs in a process of its own, building and launching its own kernel, and
prints its ``chip_smoke.k5_solo_rows()``: K5 at the Solo jump's 4 contacts
(fp64, K = 7168, kp = 0 and 50) against its plain version, timed beside
its bound; a tree whose ``chip_smoke`` has ``K5_MANY_CONTACTS`` also runs
``k5_chain_rows()`` (the chains, 20 and 40 contacts included). The last
line is one JSON object: each tree's rows in the order run, and the card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys


def child(tree):
    tree = str(pathlib.Path(tree).resolve())
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    rows = cs.k5_solo_rows()
    if hasattr(cs, "K5_MANY_CONTACTS"):
        rows.update(cs.k5_chain_rows())
    print(json.dumps({"tree": tree, "rows": rows}))


def main(trees):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--child", tree], check=True,
                             capture_output=True, text=True, timeout=1200)
        sys.stdout.write(out.stdout)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        main(sys.argv[1:])
