"""The harness finds configurations, cells, traffic and metrics by name,
and takes a cell added as files without an edit."""
import json

from portbench import harness

CELLS = ("politics-redblack-manychain", "doseresponse-seq-c4")


def test_benchmark_json_names_what_is_there():
    spec = harness.benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert set(cells) == set(CELLS)
    for name, w in cells.items():
        wl = harness.load_workload(name)
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"] == 1 and wl["why"] == w["why"]
        fam = harness.family(wl["config_data"])
        assert hasattr(fam, "build") and hasattr(fam, "prepare_device")
    for c in spec["configs"]:
        cfg = json.loads((harness.HERE.parent / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for m in spec["per_layer"]:
        mod = harness.metric_readers([m["name"]])[m["name"]]
        assert mod.UNIT == m["unit"]
        assert m["moves"] == "chain_sweeps_per_sec"


def test_per_layer_names_follow_the_workloads_key():
    row = harness.per_layer_names("politics-redblack-manychain")
    dose = harness.per_layer_names("doseresponse-seq-c4")
    assert "fused_row_ll_roofline" in row and "fused_row_ll_roofline" not in dose
    assert "blackbox_ll_ms" in dose and "blackbox_ll_ms" not in row
    assert {"sweep_mfu", "device_idle_share", "launches_per_sweep",
            "host_syncs_per_sweep", "v_update_ms", "scale_moves_ms"} \
        <= set(row) & set(dose)


def test_a_cell_added_as_files_runs(run_tiny, bench_copy):
    """The tiny cells exist only as files added to a copy; the harness
    runs them with no edit and the run reads correct."""
    assert (bench_copy / "workloads" / "tiny-poisson.json").exists()
    r = run_tiny("tiny-poisson", seed=2**31 + 7)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"chain_sweeps_per_sec", "sweep_ms_p90"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(json.loads(harness.result_line(dict(r, metrics={})))) == [
        "correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_seq_ep_cell_added_as_files_runs(run_tiny):
    """The traffic's EP (centres at the true rate) and seq schedule reach
    the model and the reference alike: the kernels' EP answers check."""
    r = run_tiny("tiny-poisson-seq-ep", seed=8)
    assert r["correct"] is True and r["failed"] == 0


def test_traced_tiny_run_reads_spans(run_tiny):
    r = run_tiny("tiny-gamma", trace=1)
    assert r["correct"] is True
    # on the CPU no device metric is read; the spans are
    assert {"v_update_ms", "scale_moves_ms", "blackbox_ll_ms",
            "sweep_mfu"} <= set(r["metrics"])
    assert "device_idle_share" not in r["metrics"]


def test_same_seed_same_inputs(bench_copy):
    import torch
    for cell in ("tiny-poisson", "tiny-gamma"):
        wl = harness.load_workload(cell, bench_copy)
        fam = harness.family(wl["config_data"], bench_copy)
        a, b, c = (fam.build(wl["config_data"], wl["traffic_data"], s,
                             torch.device("cpu")) for s in (5, 5, 6))
        ya, yb, yc = (x.Y for x in (a, b, c))
        assert ((ya == yb) | (ya != ya)).all()
        assert not ((ya == yc) | (ya != ya)).all()
