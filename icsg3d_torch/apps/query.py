# Verbatim copy of icsg3d_tpu/apps/query.py.
"""Materials Project dataset downloader.

Reference: query_matproj.py — query MPRester by anonymous formula / chemical
system, write CIFs + a property CSV.  This environment has no network
egress and no pymatgen; the CLI degrades gracefully:

- with pymatgen + network available it performs the query;
- otherwise it exits with a clear message pointing at the offline paths
  (icsg3d_torch.apps.voxelize --cifs on an existing CIF directory, or
  --synthetic for generated datasets).

The reference built its query dict with ``eval`` on user input
(query_matproj.py:37) — here the criteria are parsed safely.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import sys

# The reference's full 13-field schema (query_matproj.py:38-51).  MPRester
# returns dotted sub-document keys as flat "a.b" columns; the CSV keeps them
# verbatim, and every downstream --target flag (voxelize, train_cgcnn)
# accepts dotted column names unchanged.
PROPERTIES = [
    "task_id",
    "pretty_formula",
    "formation_energy_per_atom",
    "cif",
    "band_gap",
    "diel.poly_electronic",
    "diel.refractive_index",
    "piezo.eij_max",
    "energy_per_atom",
    "elasticity.K_Voigt_Reuss_Hill",
    "elasticity.G_Voigt_Reuss_Hill",
    "elasticity.poisson_ratio",
    "nsites",
]


def _anon_formula_dict(spec: str):
    """'ABC3' or '{"A":1,"B":1,"C":3}' -> the dict form MP stores.

    MP's anonymous_formula field is a DICT ({'A': 1.0, 'B': 1.0,
    'C': 3.0}); a raw string criterion would exact-match nothing and
    silently return zero structures (the reference eval'd a dict
    literal, query_matproj.py:37).
    """
    spec = spec.strip()
    if spec.startswith("{"):
        try:
            return {k: float(v) for k, v in json.loads(spec).items()}
        except (json.JSONDecodeError, AttributeError, ValueError) as e:
            raise SystemExit(f"--anonymous-formula: bad JSON dict: {e}")
    out = {}
    for m in re.finditer(r"([A-Z])(\d*)", spec):
        out[m.group(1)] = float(m.group(2) or 1)
    if not out or "".join(
        f"{k}{'' if v == 1 else int(v)}" for k, v in sorted(out.items())
    ) != spec:
        raise SystemExit(
            f"--anonymous-formula: cannot parse {spec!r} (use letters A-Z "
            "with optional counts, e.g. ABC3, or a JSON dict)"
        )
    return out


def build_criteria(anonymous_formula=None, system=None):
    """Safe parse of the query criteria (the reference ``eval``-ed the
    user's string, query_matproj.py:37)."""
    criteria = {}
    if anonymous_formula:
        criteria["anonymous_formula"] = _anon_formula_dict(anonymous_formula)
    if system:
        # MP stores chemsys with alphabetically sorted elements
        # ('Fe-Li-O'); an unsorted exact match returns nothing
        criteria["chemsys"] = "-".join(sorted(system.split("-")))
    return criteria


def write_docs(docs, name, out="data") -> int:
    """Write MPRester-style docs to the reference layout: per-structure
    CIFs plus <name>.csv with every non-cif column (query_matproj.py:63-80).
    Dotted sub-document keys stay verbatim as CSV column names."""
    cif_dir = os.path.join(out, name, "cifs")
    os.makedirs(cif_dir, exist_ok=True)
    rows = []
    for doc in docs:
        if not isinstance(doc, dict) or "task_id" not in doc:
            raise SystemExit(
                "dump entries must be MPRester-style dicts with a "
                f"task_id; got {type(doc).__name__}"
            )
        # ids come from an untrusted dump: never let a crafted
        # '../../...' id write outside the cifs directory
        task_id = os.path.basename(str(doc["task_id"]))
        if doc.get("cif"):
            with open(os.path.join(cif_dir, f"{task_id}.cif"), "w") as f:
                f.write(doc["cif"])
        rows.append({k: doc.get(k) for k in PROPERTIES if k != "cif"})
    with open(os.path.join(out, name, f"{name}.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=[k for k in PROPERTIES if k != "cif"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} structures -> {os.path.join(out, name)}")
    return 0


def run_query(
    api_key, name, anonymous_formula=None, system=None, out="data",
    from_json=None,
):
    if from_json:
        try:
            with open(from_json) as f:
                docs = json.load(f)
        except FileNotFoundError:
            print(f"--from-json: no such file: {from_json}", file=sys.stderr)
            return 1
        except json.JSONDecodeError as e:
            print(f"--from-json: malformed JSON: {e}", file=sys.stderr)
            return 1
        if not isinstance(docs, list):
            print("--from-json: expected a LIST of MPRester docs",
                  file=sys.stderr)
            return 1
        return write_docs(docs, name, out)

    try:
        from pymatgen.ext.matproj import MPRester  # noqa: F401
    except ImportError:
        print(
            "pymatgen is not available in this environment; the Materials "
            "Project query path needs it.\n"
            "Offline alternatives:\n"
            "  python -m icsg3d_torch.apps.query --from-json <mp_dump.json> ...\n"
            "  python -m icsg3d_torch.apps.voxelize --cifs <dir> --out <dataset>\n"
            "  python -m icsg3d_torch.apps.voxelize --synthetic 1000 --out <dataset>",
            file=sys.stderr,
        )
        return 1

    criteria = build_criteria(anonymous_formula, system)
    with MPRester(api_key) as mpr:
        docs = mpr.query(criteria=criteria, properties=PROPERTIES)
    # save the raw dump like the reference (query_matproj.py:60-62) — it
    # is the exact input --from-json replays, so an expensive rate-
    # limited query never needs re-running
    os.makedirs(os.path.join(out, name), exist_ok=True)
    with open(os.path.join(out, name, f"{name}.json"), "w") as f:
        json.dump(docs, f)
    return write_docs(docs, name, out)


def main(argv=None):
    p = argparse.ArgumentParser(description="Query the Materials Project")
    p.add_argument("--key", default=None, help="Materials Project API key")
    p.add_argument("--name", required=True)
    p.add_argument("--anonymous-formula", default=None, help="e.g. ABC3")
    p.add_argument("--system", default=None, help="e.g. Li-Fe-O")
    p.add_argument("--out", default="data")
    p.add_argument(
        "--from-json", default=None,
        help="offline mode: write CIFs+CSV from a saved MPRester JSON dump "
             "(the reference saved exactly this file, query_matproj.py:60-62) "
             "instead of querying the network",
    )
    args = p.parse_args(argv)
    if not args.key and not args.from_json:
        p.error("need --key (network query) or --from-json (offline dump)")
    if args.from_json and (args.anonymous_formula or args.system):
        p.error("--from-json replays the dump unfiltered; drop "
                "--anonymous-formula/--system (filter when querying)")
    sys.exit(
        run_query(
            args.key, args.name, args.anonymous_formula, args.system,
            args.out, from_json=args.from_json,
        )
    )


if __name__ == "__main__":
    main()
