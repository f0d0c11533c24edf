# Verbatim copy of icsg3d_tpu/crystal/cif.py.
"""Minimal CIF reader/writer.

Replaces pymatgen's CifParser/CifWriter for the pipeline's needs
(utils.py:148-157 parses CIFs into structures; generate.py:265-267 writes
generated structures back out).  Handles the symmetrized CIFs served by the
Materials Project: cell parameters, `_symmetry_equiv_pos_as_xyz` operator
loops (applied to the asymmetric unit with deduplication), and atom-site
loops with fractional coordinates and occupancies.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from icsg3d_torch.crystal import elements
from icsg3d_torch.crystal.lattice import Lattice
from icsg3d_torch.crystal.structure import Site, Structure

_NUM_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")
_UNKNOWN_MARKS = ("?", ".")  # CIF unknown/not-applicable value markers


def _parse_number(token: str, default: Optional[float] = None) -> float:
    """Parse a CIF numeric token, stripping uncertainty suffixes like 1.23(4).

    ``default`` is returned for the CIF unknown markers '?' and '.'
    (callers that can degrade, e.g. occupancy -> 1.0, pass one; others
    get a clear error naming the token).
    """
    tok = token.strip()
    if tok in _UNKNOWN_MARKS:
        if default is not None:
            return default
        raise ValueError(f"CIF unknown-value marker {tok!r} where a "
                         "number is required")
    m = _NUM_RE.match(tok)
    if not m:
        raise ValueError(f"not a number: {token!r}")
    val = float(m.group(0))
    # overflowed literals like 1e999 become inf and would flow NaN into
    # downstream math (inf % 1.0) — a silent-corruption path, not an error
    if not np.isfinite(val):
        raise ValueError(f"non-finite number: {token!r}")
    return val


def _tokenize_line(line: str) -> List[str]:
    """Split a CIF data line into tokens, honoring quoted strings."""
    return re.findall(r"'[^']*'|\"[^\"]*\"|\S+", line)


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    return tok


def _resolve_element(raw: str) -> Optional[int]:
    """Atomic number from a type symbol or site label; None to skip the row.

    Handles case-insensitive labels ('NA1' is sodium, not nitrogen — the
    symbol table is case-sensitive, so 'NA' must capitalize before the
    single-letter fallback fires), deuterium/tritium labels, and raises a
    clear error for unmatchable tokens instead of a KeyError.
    """
    m = re.match(r"[A-Za-z]{1,2}", raw)
    if not m:
        return None
    tok = m.group(0)
    for cand in (tok.capitalize(), tok[0].upper()):
        try:
            return elements.symbol_to_z(cand)
        except KeyError:
            continue
    if tok[0].upper() in ("D", "T"):  # heavy-hydrogen labels
        return 1
    raise ValueError(f"unknown element symbol in atom site: {raw!r}")


def _parse_affine(p: str) -> Tuple[np.ndarray, float]:
    """One symop component like ``-y``, ``x-y`` or ``1/2+z`` ->
    (coefficients over (x, y, z), constant).

    A real term parser, NOT eval: file-derived text must never reach the
    interpreter (a crafted component like ``9**9**9**9`` would pass a
    charset check and hang the process inside eval), and non-affine
    expressions must error rather than silently linearize.
    """
    p = p.replace(" ", "").lower()
    if not p or not re.fullmatch(r"[xyz0-9+\-*/.]+", p) or "**" in p:
        raise ValueError(f"bad symop component: {p!r}")
    coeffs = np.zeros(3)
    const = 0.0
    for term in re.findall(r"[+-]?[^+-]+", p):
        sign = -1.0 if term.startswith("-") else 1.0
        body = term.lstrip("+-")
        if not body:
            raise ValueError(f"bad symop component: {p!r}")
        var = next((v for v in "xyz" if v in body), None)
        if var is not None:
            if sum(body.count(v) for v in "xyz") != 1:
                raise ValueError(f"non-affine symop component: {p!r}")
            body = body.replace("*", "").replace(var, "")
        try:
            if body == "":
                val = 1.0
            elif "/" in body:
                num, den = body.split("/", 1)
                val = (float(num) if num else 1.0) / float(den)
            else:
                val = float(body)
        except ZeroDivisionError:
            raise ValueError(f"zero denominator in symop component: {p!r}")
        if not np.isfinite(val):
            raise ValueError(f"non-finite symop component: {p!r}")
        if var is not None:
            coeffs["xyz".index(var)] += sign * val
        else:
            const += sign * val
    return coeffs, const


def parse_symop(expr: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one symmetry operator like ``-y, x-y, z+1/2`` into (R, t) with
    new_frac = frac @ R.T + t."""
    parts = [p.strip() for p in expr.split(",")]
    if len(parts) != 3:
        raise ValueError(f"bad symop: {expr!r}")
    R = np.zeros((3, 3))
    t = np.zeros(3)
    for i, p in enumerate(parts):
        R[i], t[i] = _parse_affine(p)
    return R, t


def _collect_loops(lines: List[str]):
    """Yield (headers, rows) for each loop_ block plus a dict of scalar tags."""
    scalars: Dict[str, str] = {}
    loops = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.lower() == "loop_":
            i += 1
            headers = []
            # comments are insignificant anywhere in CIF, including
            # between a loop_ keyword, its headers, and its rows
            # (found by the mutation fuzzer; pymatgen-parity behavior)
            while i < n and (lines[i].strip().startswith("_")
                             or lines[i].strip().startswith("#")):
                if not lines[i].strip().startswith("#"):
                    headers.append(lines[i].strip().split()[0].lower())
                i += 1
            if not headers:
                # a bare loop_ with no tag lines (malformed); skip it
                # rather than divide by a zero column count below
                continue
            rows = []
            while i < n:
                row_line = lines[i].strip()
                if row_line.startswith("#"):
                    i += 1
                    continue
                if (not row_line
                        or row_line.startswith("_")
                        or row_line.lower().startswith(("loop_", "data_"))):
                    break
                toks = _tokenize_line(row_line)
                # CIF rows may wrap; accumulate until we have enough tokens
                while len(toks) < len(headers) and i + 1 < n:
                    nxt = lines[i + 1].strip()
                    if (not nxt or nxt.startswith(("_", "#"))
                            or nxt.lower().startswith(("loop_", "data_"))):
                        break
                    i += 1
                    toks.extend(_tokenize_line(nxt))
                # the CIF spec treats loop values as a flat token stream:
                # one physical line may pack several complete rows (emit
                # them all), and unquoted values with spaces leave extra
                # tokens on the row (kept — consumers may re-join them)
                if len(toks) >= 2 * len(headers):
                    for r0 in range(0, len(toks) // len(headers)):
                        rows.append(
                            toks[r0 * len(headers):(r0 + 1) * len(headers)]
                        )
                elif len(toks) >= len(headers):
                    rows.append(toks)
                i += 1
            loops.append((headers, rows))
        elif line.startswith("_"):
            toks = _tokenize_line(line)
            key = toks[0].lower()
            if len(toks) > 1:
                scalars[key] = _unquote(" ".join(toks[1:]))
            elif i + 1 < n and lines[i + 1].lstrip().startswith(";"):
                # semicolon-delimited text field: consume to the closing
                # ';' (its body lines may start with '_' or 'loop_' and
                # must not be parsed as tags)
                i += 2
                buf = []
                while i < n and not lines[i].strip().startswith(";"):
                    buf.append(lines[i])
                    i += 1
                scalars[key] = "\n".join(buf)
            elif i + 1 < n and not (
                lines[i + 1].strip().startswith(("_", "#"))
                or lines[i + 1].strip().lower().startswith(("loop_", "data_"))
            ):
                scalars[key] = _unquote(lines[i + 1].strip())
                i += 1
            i += 1
            continue
        else:
            i += 1
            continue
    return scalars, loops


def parse_cif(text: str, site_tol: float = 1e-3) -> Structure:
    """Parse CIF text into a Structure with all symmetry-equivalent sites.

    Multi-block files use the FIRST ``data_`` block only (the reference's
    CifParser.get_structures()[0] semantics) — merging blocks would apply
    one block's symmetry to another's sites.
    """
    lines = text.splitlines()
    starts = [k for k, ln in enumerate(lines)
              if ln.strip().lower().startswith("data_")]
    if len(starts) >= 2:
        lines = lines[: starts[1]]
    scalars, loops = _collect_loops(lines)

    def cell(tag: str) -> float:
        key = f"_cell_length_{tag}" if tag in "abc" else f"_cell_angle_{tag}"
        if key not in scalars:
            raise ValueError(f"CIF missing required cell tag {key}")
        return _parse_number(scalars[key])

    abc = [cell(t) for t in "abc"]
    angles = [cell(t) for t in ("alpha", "beta", "gamma")]
    if any(v <= 0 for v in abc):
        raise ValueError(f"non-positive cell length: {abc}")
    if any(not 0.0 < v < 180.0 for v in angles):
        raise ValueError(f"cell angle outside (0, 180): {angles}")
    lattice = Lattice.from_parameters(*abc, *angles)
    if not np.isfinite(lattice.matrix).all():
        # degenerate angle combinations (e.g. alpha+beta+gamma ~ 360)
        # produce sqrt of a negative in the triclinic construction
        raise ValueError(
            f"degenerate cell parameters: abc={abc} angles={angles}"
        )

    symops: List[Tuple[np.ndarray, np.ndarray]] = []
    site_loop = None
    for headers, rows in loops:
        if any(h.endswith(("equiv_pos_as_xyz", "space_group_symop_operation_xyz"))
               for h in headers):
            col = next(
                k for k, h in enumerate(headers)
                if h.endswith(("equiv_pos_as_xyz", "space_group_symop_operation_xyz"))
            )
            try:
                for row in rows:
                    symops.append(parse_symop(_unquote(row[col])))
            except ValueError:
                # Unquoted operators with spaces ('1 x, y, z') tokenize
                # into fragments (and may have been re-chunked as packed
                # rows).  Reconstruct from the loop's full token stream:
                # drop integer id tokens, re-join, split into ops of
                # exactly three comma-separated components.
                symops = []
                text = " ".join(
                    _unquote(tk) for row in rows for tk in row
                    if not re.fullmatch(r"\d+", _unquote(tk))
                )
                # comma splits components WITHIN an operator; whitespace
                # separates one operator's last component from the next
                # operator (no comma between ops) — except when it just
                # breaks around +-*/ inside a single expression
                parts: List[str] = []
                for qpart in text.split(","):
                    for tk in qpart.split():
                        if parts and (
                            parts[-1] and parts[-1][-1] in "+-*/"
                            or tk in "+-*/" or tk[0] in "*/"
                        ):
                            parts[-1] += tk
                        else:
                            parts.append(tk)
                    parts.append("\x00")  # comma boundary marker
                parts = [q for q in parts if q != "\x00"]
                if len(parts) % 3:
                    raise ValueError(f"bad symop loop: {text!r}")
                for k in range(0, len(parts), 3):
                    symops.append(parse_symop(", ".join(parts[k:k + 3])))
        if any(h == "_atom_site_fract_x" for h in headers):
            site_loop = (headers, rows)
    if not symops:
        symops = [(np.eye(3), np.zeros(3))]
    if site_loop is None:
        raise ValueError("CIF has no atom-site loop")

    headers, rows = site_loop

    def col(name: str) -> Optional[int]:
        try:
            return headers.index(name)
        except ValueError:
            return None

    c_sym = col("_atom_site_type_symbol")
    c_lab = col("_atom_site_label")
    if c_sym is None and c_lab is None:
        raise ValueError(
            "atom-site loop has neither _atom_site_type_symbol nor "
            "_atom_site_label"
        )
    c_x, c_y, c_z = (col(f"_atom_site_fract_{ax}") for ax in "xyz")
    for name, c in zip(("x", "y", "z"), (c_x, c_y, c_z)):
        if c is None:
            raise ValueError(f"atom-site loop missing _atom_site_fract_{name}")
    c_occ = col("_atom_site_occupancy")

    sites: List[Site] = []
    seen: List[Tuple[int, np.ndarray]] = []  # (z, position)
    for row in rows:
        raw_sym = _unquote(row[c_sym] if c_sym is not None else row[c_lab])
        z = _resolve_element(raw_sym)
        if z is None:
            continue
        frac = np.array([_parse_number(row[c]) for c in (c_x, c_y, c_z)])
        occ = _parse_number(row[c_occ], default=1.0) if c_occ is not None else 1.0
        # Deduplicate (z, position): symmetry images of the same row
        # coincide on special positions.  The key includes z so a second
        # SPECIES co-occupying the same coordinates (disordered CIFs)
        # is kept — a position-only key silently deleted it.
        row_new = []
        for R, t in symops:
            new = (frac @ R.T + t) % 1.0
            new[new > 1.0 - site_tol] = 0.0
            row_new.append(new)
        same_z = [p for (pz, p) in seen if pz == z]
        for new in row_new:
            if same_z:
                d = np.linalg.norm(
                    ((new - np.stack(same_z) + 0.5) % 1.0) - 0.5, axis=1
                )
                if float(d.min()) < site_tol:
                    continue
            same_z.append(new)
            seen.append((z, new))
            sites.append(Site(z, new, occ))
    return Structure(lattice, sites)


def read_cif(path: str, ordered: bool = True) -> Structure:
    """Read a CIF file; optionally order disordered structures.

    Mirrors create_crystal (utils.py:148-157): parse, and if not ordered,
    apply an ordering transformation.
    """
    with open(path) as f:
        structure = parse_cif(f.read())
    if ordered and not structure.is_ordered():
        structure = structure.order_sites()
    return structure


def structure_to_cif(structure: Structure, name: str = "generated") -> str:
    """Serialize a Structure to P1 CIF text (CifWriter equivalent)."""
    lat = structure.lattice
    a, b, c, alpha, beta, gamma = lat.parameters
    lines = [
        "# generated by icsg3d-tpu",
        f"data_{name.replace(' ', '_')}",
        "_symmetry_space_group_name_H-M   'P 1'",
        f"_cell_length_a   {a:.8f}",
        f"_cell_length_b   {b:.8f}",
        f"_cell_length_c   {c:.8f}",
        f"_cell_angle_alpha   {alpha:.8f}",
        f"_cell_angle_beta   {beta:.8f}",
        f"_cell_angle_gamma   {gamma:.8f}",
        "_symmetry_Int_Tables_number   1",
        f"_chemical_formula_sum   '{structure.formula}'",
        f"_cell_volume   {lat.volume:.8f}",
        "loop_",
        " _symmetry_equiv_pos_site_id",
        " _symmetry_equiv_pos_as_xyz",
        "  1  'x, y, z'",
        "loop_",
        " _atom_site_type_symbol",
        " _atom_site_label",
        " _atom_site_symmetry_multiplicity",
        " _atom_site_fract_x",
        " _atom_site_fract_y",
        " _atom_site_fract_z",
        " _atom_site_occupancy",
    ]
    counts: Dict[str, int] = {}
    for site in structure.sites:
        sym = site.symbol
        counts[sym] = counts.get(sym, 0) + 1
        f = site.frac_coords % 1.0
        lines.append(
            f"  {sym}  {sym}{counts[sym] - 1}  1  "
            f"{f[0]:.8f}  {f[1]:.8f}  {f[2]:.8f}  {site.occupancy:g}"
        )
    return "\n".join(lines) + "\n"


def write_cif(structure: Structure, path: str, name: str = "generated") -> None:
    with open(path, "w") as f:
        f.write(structure_to_cif(structure, name=name))
