"""The port's dry-run table (``launch/roofline_table.py``) against JAX's
``benchmarks/roofline.py::render`` (CPU): a temporary directory of port
records (ok on two meshes, skip, error) renders, in markdown and in CSV,
the rows and columns JAX's renderer gives for the same records after the
field mapping (the port's ``memory_s_ideal`` under JAX's
``memory_s_pallas_ideal``; ``collective_s`` not counted, "-"); the mesh
filter keeps only its mesh's records; the CLI reads ``--dir``."""
import json

import pytest

pytest.importorskip("torch")
try:
    from benchmarks import roofline as jax_roofline
except ImportError:
    jax_roofline = None
needs_ref = pytest.mark.skipif(jax_roofline is None,
                               reason="needs the JAX package's renderer")

from repro_torch.launch import dryrun, roofline_table  # noqa: E402


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Port records: gemma3-1b decode_32k ok on the host and a pod mesh,
    hubert-xlarge decode_32k skip, and an error record."""
    d = tmp_path_factory.mktemp("records")
    recs = [dryrun.run_one("gemma3-1b", "decode_32k", mesh, out_dir=str(d),
                           verbose=False)
            for mesh in ("host1x1", "pod16x16")]
    recs.append(dryrun.run_one("hubert-xlarge", "decode_32k", "pod16x16",
                               out_dir=str(d), verbose=False))
    err = {"arch": "minitron-4b", "shape": "train_4k", "mesh": "pod16x16",
           "status": "error", "error": "RuntimeError: boom"}
    (d / "minitron-4b__train_4k__pod16x16.json").write_text(json.dumps(err))
    assert [r["status"] for r in recs] == ["ok", "ok", "skip"]
    return d


def _as_jax(rec: dict) -> dict:
    """A port record with JAX's field names (the renderer's mapping)."""
    out = dict(rec)
    if "memory_s_ideal" in rec:
        out["memory_s_pallas_ideal"] = rec["memory_s_ideal"]
    out.pop("collective_s", None)
    return out


@needs_ref
@pytest.mark.parametrize("markdown", [True, False])
@pytest.mark.parametrize("mesh", [None, "pod16x16", "host1x1"])
def test_render_equals_jax_after_the_field_mapping(records, tmp_path,
                                                   monkeypatch, markdown,
                                                   mesh):
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for f in records.glob("*.json"):
        (jdir / f.name).write_text(json.dumps(_as_jax(json.loads(
            f.read_text()))))
    monkeypatch.setattr(jax_roofline, "RESULTS_DIR", str(jdir))
    got = roofline_table.render(markdown=markdown, mesh=mesh,
                                results_dir=str(records))
    assert got == jax_roofline.render(markdown=markdown, mesh=mesh)


def test_rows_columns_and_mesh_filter(records):
    md = roofline_table.render(markdown=True, results_dir=str(records))
    lines = md.splitlines()
    assert lines[0] == "| " + " | ".join(roofline_table.COLS) + " |"
    rows = [ln.strip("| ").split(" | ") for ln in lines[2:]]
    assert [r[:4] for r in rows] == [
        ["gemma3-1b", "decode_32k", "host1x1", "ok"],
        ["gemma3-1b", "decode_32k", "pod16x16", "ok"],
        ["hubert-xlarge", "decode_32k", "pod16x16",
         "skip (encoder-only: no autoregressive decode)"],
        ["minitron-4b", "train_4k", "pod16x16", "error"]]
    assert all(len(r) == len(roofline_table.COLS) for r in rows)
    host = json.loads((records / "gemma3-1b__decode_32k__host1x1.json")
                      .read_text())
    col = dict(zip(roofline_table.COLS, rows[0]))
    assert col["collective_s"] == "-"
    assert col["memory_s_pallas_ideal"] == f"{host['memory_s_ideal']:.3g}"
    assert col["peak_bytes"] == f"{host['peak_bytes'] / 2**30:.1f}Gi"
    assert dict(zip(roofline_table.COLS, rows[1]))["peak_bytes"] == "-"
    assert rows[2][4:] == ["-"] * (len(roofline_table.COLS) - 4)
    csv = roofline_table.render(markdown=False, mesh="host1x1",
                                results_dir=str(records)).splitlines()
    assert csv[0] == ",".join(roofline_table.COLS)
    assert [ln.split(",")[:3] for ln in csv[1:]] == [
        ["gemma3-1b", "decode_32k", "host1x1"]]


def test_cli_reads_the_directory_it_is_given(records, capsys):
    roofline_table.main(["--markdown", "--mesh", "pod16x16", "--dir",
                         str(records)])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 + 3
    assert all("pod16x16" in ln for ln in out[2:])
