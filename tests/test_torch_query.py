"""The port's Materials Project query CLI against icsg3d_tpu's (no network).

apps/query.py is a verbatim copy (tests/test_torch_guards.py holds the
text); these tests hold its behaviour: the offline replay of a dump writes
byte-identical CSV and CIFs, the criteria parse the same specs to the same
dicts and refuse the same bad ones, and without pymatgen the network path
exits with rc 1 and names the offline alternatives.
"""

import json
import os

import pytest

from icsg3d_torch.apps import query as tquery
from icsg3d_tpu.apps import query as jquery

DOCS = [
    {"task_id": "mp-1", "pretty_formula": "NaCl", "formation_energy_per_atom": -2.1,
     "cif": "data_NaCl\n_cell_length_a 5.64\n", "band_gap": 5.0, "nsites": 2,
     "elasticity.K_Voigt_Reuss_Hill": 24.0},
    {"task_id": "../../escape", "pretty_formula": "MgO", "cif": "data_MgO\n",
     "diel.poly_electronic": 3.0},
    {"task_id": "mp-3", "pretty_formula": "Fe", "cif": None, "nsites": 1},
]


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_from_json_writes_the_same_bytes(tmp_path, capsys):
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(DOCS))
    rcs = [mod.run_query(None, "demo", out=str(tmp_path / name), from_json=str(dump))
           for mod, name in ((jquery, "jax"), (tquery, "port"))]
    assert rcs == [0, 0]
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want
    assert set(got) == {os.path.join("demo", "demo.csv"),
                        os.path.join("demo", "cifs", "mp-1.cif"),
                        os.path.join("demo", "cifs", "escape.cif")}


@pytest.mark.parametrize("content,want", [
    ("nope", "no such file"), ("{not json", "malformed JSON"),
    ('{"a": 1}', "expected a LIST"),
])
def test_from_json_refusals_match(tmp_path, capsys, content, want):
    dump = tmp_path / "dump.json"
    if content != "nope":
        dump.write_text(content)
    for mod in (jquery, tquery):
        assert mod.run_query(None, "x", out=str(tmp_path), from_json=str(dump)) == 1
        assert want in capsys.readouterr().err


@pytest.mark.parametrize("anon,system", [
    ("ABC3", None), ("AB", "O-Li-Fe"), ('{"A": 1, "B": 2}', None), (None, "Si"),
    (None, None), ("A2B3", "Zr-O"), ("ABC", None),
])
def test_build_criteria_matches(anon, system):
    assert tquery.build_criteria(anon, system) == jquery.build_criteria(anon, system)


@pytest.mark.parametrize("anon", ["abc", "A1B", "BA", "{bad", "", "A-B", "AB2C!"])
def test_build_criteria_refuses_the_same_specs(anon):
    outcomes = []
    for mod in (jquery, tquery):
        try:
            outcomes.append(("ok", mod.build_criteria(anon, None)))
        except SystemExit as e:
            outcomes.append(("exit", str(e.code)))
    assert outcomes[0] == outcomes[1]


def test_offline_query_exits_1_without_pymatgen(tmp_path, capsys):
    rc = tquery.run_query("key", "demo", anonymous_formula="ABC3", out=str(tmp_path))
    assert rc == 1
    err = capsys.readouterr().err
    assert "pymatgen is not available" in err
    assert "python -m icsg3d_torch.apps.query --from-json" in err
    assert not os.listdir(tmp_path)


def test_main_refusals_and_replay(tmp_path):
    with pytest.raises(SystemExit) as exc:
        tquery.main(["--name", "x"])
    assert exc.value.code == 2
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps(DOCS[:1]))
    with pytest.raises(SystemExit) as exc:
        tquery.main(["--name", "x", "--from-json", str(dump), "--system", "Na-Cl"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        tquery.main(["--name", "x", "--from-json", str(dump), "--out", str(tmp_path)])
    assert exc.value.code == 0
    assert os.path.exists(tmp_path / "x" / "cifs" / "mp-1.cif")
