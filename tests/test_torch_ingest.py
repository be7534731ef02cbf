"""The port's capture ingestion (``repro_torch.traces.ingest``) and its CLI
``ingest`` against the JAX package.

Contract: on the same CSV and pcap files, stages and seeds the port's
readers, stages and ``Pipeline`` give the reference's traces bit for bit
(times, ids, payloads, name, ports, link rate); CSV and synthetic pcap
captures round-trip through ``.npz``; pipelines are order-deterministic,
serializable data and seed-reproducible; ``python -m repro_torch ingest``
writes the same ``.npz`` as the reference's ``spac ingest`` and exits 2 on
malformed input; ``traces.merge`` validates its inputs as the reference's.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import importlib  # noqa: E402
import struct  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.api.cli import main as ref_cli  # noqa: E402
from repro.traces import Trace as RefTrace  # noqa: E402

# the module (the package exports a function of the same name)
ref_ingest = importlib.import_module("repro.traces.ingest")

from repro_torch.api.cli import main as port_cli  # noqa: E402
from repro_torch.traces import Trace, merge  # noqa: E402
from repro_torch.traces.ingest import (IngestError, Pipeline, STAGES, Stage,  # noqa: E402
                                       ingest, read_csv, read_pcap, write_pcap)

CSV_HEADER = "time_s,src,dst,payload_bytes"


def _write(path, text):
    path.write_text(text)
    return str(path)


def _assert_traces_bit_equal(a, b):
    np.testing.assert_array_equal(a.time_s, b.time_s)
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    np.testing.assert_array_equal(a.payload_bytes, b.payload_bytes)
    assert a.time_s.dtype == b.time_s.dtype and a.src.dtype == b.src.dtype
    assert (a.name, a.n_ports, a.link_gbps) == (b.name, b.n_ports, b.link_gbps)


def _base_arrays(m=200, n_ports=8, seed=3):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(0, 1e-4, m)),
            rng.integers(n_ports, size=m).astype(np.int32),
            rng.integers(n_ports, size=m).astype(np.int32),
            rng.integers(64, 1500, size=m).astype(np.int64))


def _base_pair(**kw):
    arrays = _base_arrays(**kw)
    n = kw.get("n_ports", 8)
    return Trace("base", *arrays, n_ports=n), RefTrace("base", *arrays, n_ports=n)


# --------------------------------------------------------------------------
# readers: the reference's traces, and round trips through .npz
# --------------------------------------------------------------------------

def test_csv_equals_reference_and_roundtrips(tmp_path):
    p = _write(tmp_path / "cap.csv",
               "dst,payload_bytes,flow_label,time_s,src\n"
               "1,64,a,0.0,0\n"
               "2,128,b,1e-6,1\n"
               "0,1500,c,2.5e-6,3\n")
    tr = read_csv(p, n_ports=4, link_gbps=25.0)
    _assert_traces_bit_equal(tr, ref_ingest.read_csv(p, n_ports=4,
                                                     link_gbps=25.0))
    out = tmp_path / "cap.npz"
    tr.save(out)
    _assert_traces_bit_equal(Trace.load(out), tr)
    _assert_traces_bit_equal(RefTrace.load(out), tr)      # one .npz format
    rows = "0.0,0,1,64\n1e-6,1,2,128\n"
    with_h = read_csv(_write(tmp_path / "a.csv", CSV_HEADER + "\n" + rows),
                      name="cap")
    without = read_csv(_write(tmp_path / "b.csv", rows), name="cap")
    _assert_traces_bit_equal(with_h, without)


def test_pcap_equals_reference_and_roundtrips(tmp_path):
    t_ns = [0, 1_000, 999_999_999, 1_000_000_001, 7_123_456_789]
    src = [0, 300, 2, 65535, 4]
    dst = [1, 2, 300, 4, 0]
    pay = [64, 1500, 9000, 46, 128]
    p, q = tmp_path / "cap.pcap", tmp_path / "ref.pcap"
    write_pcap(p, t_ns, src, dst, pay)
    ref_ingest.write_pcap(q, t_ns, src, dst, pay)
    assert p.read_bytes() == q.read_bytes()
    tr = read_pcap(p)
    _assert_traces_bit_equal(tr, ref_ingest.read_pcap(p))
    np.testing.assert_array_equal(tr.src, src)
    np.testing.assert_array_equal(
        tr.time_s, np.array([t * 1e-9 for t in t_ns]))
    out = tmp_path / "cap.npz"
    tr.save(out)
    _assert_traces_bit_equal(Trace.load(out), tr)
    # ingest() dispatches on the pcap magic even without the suffix
    bare = tmp_path / "capture"
    bare.write_bytes(p.read_bytes())
    _assert_traces_bit_equal(ingest(bare, name="cap"), read_pcap(p, name="cap"))


def test_pcap_rejects_malformed_input(tmp_path):
    p = tmp_path / "x.pcap"
    p.write_bytes(b"\x0a\x0d\x0d\x0a" + b"\x00" * 20)      # pcapng magic
    with pytest.raises(IngestError, match="pcapng"):
        read_pcap(p)
    p.write_bytes(struct.pack("<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 65535, 101))
    with pytest.raises(IngestError, match="linktype"):     # not Ethernet
        read_pcap(p)
    write_pcap(p, [0], [0], [1], [64])
    p.write_bytes(p.read_bytes()[:-4])                     # truncated record
    with pytest.raises(IngestError, match="truncated"):
        read_pcap(p)
    with pytest.raises(IngestError, match="unrecognised"):
        ingest(_write(tmp_path / "cap.json", "{}"))


def test_reader_validates_port_range(tmp_path):
    p = _write(tmp_path / "cap.csv", CSV_HEADER + "\n0.0,0,9,64\n")
    with pytest.raises(IngestError, match="port id 9"):
        read_csv(p, n_ports=4)
    assert read_csv(p).n_ports == 10                       # inferred


# --------------------------------------------------------------------------
# stages and pipelines: the reference's traces at the same seeds
# --------------------------------------------------------------------------

STAGE_CASES = [
    ("filter", {"min_payload": 300, "max_payload": 1200, "t_start": 1e-5,
                "t_stop": 9e-5, "ports": [0, 1, 2, 5]}),
    ("remap_ports", {"n_ports": 3}),
    ("remap_ports", {"mapping": {i: 7 - i for i in range(8)}}),
    ("rescale_time", {"factor": 0.25, "origin": True}),
    ("clip", {"max_packets": 50, "duration_s": 6e-5}),
    ("incast", {"dst": 2, "n_senders": 5, "n_packets": 64}),
    ("zipf_drift", {"alpha": 1.1, "frac": 0.6, "n_phases": 3}),
    ("diurnal", {"periods": 2.0, "depth": 0.7}),
]


@pytest.mark.parametrize("kind,params", STAGE_CASES,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(STAGE_CASES)])
def test_each_stage_equals_reference(kind, params):
    assert set(STAGES) == set(ref_ingest.STAGES)
    port, ref = _base_pair()
    for seed in (0, 42):
        got = Pipeline(seed=seed).then(kind, **params).apply(port)
        want = ref_ingest.Pipeline(seed=seed).then(kind, **params).apply(ref)
        _assert_traces_bit_equal(got, want)


def test_pipeline_equals_reference_and_is_serializable_data():
    spec = (Pipeline(seed=9).then("filter", min_payload=100)
            .then("remap_ports", n_ports=6)
            .then("incast", dst=2, n_senders=3, n_packets=32)
            .then("zipf_drift", alpha=1.3)
            .then("diurnal", periods=3.0, depth=0.4)
            .then("rescale_time", factor=2.0)
            .then("clip", duration_s=1.5e-4))
    again = Pipeline.from_dict(spec.to_dict())
    assert again == spec
    ref = ref_ingest.Pipeline.from_dict(spec.to_dict())
    assert ref.to_dict() == spec.to_dict()
    port, ref_tr = _base_pair()
    got = spec.apply(port)
    _assert_traces_bit_equal(got, again.apply(port))
    _assert_traces_bit_equal(got, ref.apply(ref_tr))
    with pytest.raises(IngestError, match="unknown stage"):
        Stage("nosuch")
    with pytest.raises(IngestError, match="filter"):
        Pipeline().then("filter", bogus_param=1).apply(port)


def test_stage_composition_is_order_deterministic():
    tr, _ = _base_pair()
    a = Pipeline(seed=0).then("rescale_time", factor=2.0) \
                        .then("clip", duration_s=1e-4).apply(tr)
    b = Pipeline(seed=0).then("clip", duration_s=1e-4) \
                        .then("rescale_time", factor=2.0).apply(tr)
    assert len(a) < len(b)


@pytest.mark.parametrize("kind,params,stochastic", [
    ("incast", {"dst": 0, "n_senders": 5, "n_packets": 64}, True),
    ("zipf_drift", {"alpha": 1.1, "frac": 0.6, "n_phases": 3}, True),
    ("diurnal", {"periods": 2.0, "depth": 0.7}, False),
])
def test_stressors_are_seed_reproducible(kind, params, stochastic):
    tr, _ = _base_pair()
    one = Pipeline(seed=42).then(kind, **params).apply(tr)
    two = Pipeline(seed=42).then(kind, **params).apply(tr)
    _assert_traces_bit_equal(one, two)
    other = Pipeline(seed=43).then(kind, **params).apply(tr)
    diverged = (len(other) != len(one)
                or not np.array_equal(other.time_s, one.time_s)
                or not np.array_equal(other.dst, one.dst))
    assert diverged == stochastic


def test_stage_parameter_validation():
    tr, _ = _base_pair()
    with pytest.raises(IngestError, match="factor"):
        Pipeline().then("rescale_time", factor=0.0).apply(tr)
    with pytest.raises(IngestError, match="depth"):
        Pipeline().then("diurnal", depth=1.5).apply(tr)
    with pytest.raises(IngestError, match="remap_ports"):
        Pipeline().then("remap_ports").apply(tr)
    with pytest.raises(IngestError, match="no mapping"):
        Pipeline().then("remap_ports", mapping={0: 0}).apply(tr)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_ingest_writes_the_reference_npz(tmp_path, capsys):
    cap = _write(tmp_path / "cap.csv",
                 CSV_HEADER + "\n0.0,0,1,64\n1e-6,1,0,128\n3e-6,2,1,256\n")
    args = ["--seed", "7", "--n-ports", "4", "--link-gbps", "25",
            "--stage", "incast:dst=0,n_senders=2,n_packets=8",
            "--stage", "filter:ports=[0,1,2,3]",
            "--stage", "clip:max_packets=9"]
    out, ref_out = tmp_path / "port.npz", tmp_path / "ref.npz"
    assert port_cli(["ingest", cap, "-o", str(out), *args]) == 0
    assert ref_cli(["ingest", cap, "-o", str(ref_out), *args]) == 0
    tr = Trace.load(out)
    assert len(tr) == 9 and tr.name == "cap"
    _assert_traces_bit_equal(tr, Trace.load(ref_out))
    with np.load(out) as a, np.load(ref_out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert "wrote" in capsys.readouterr().out
    # default output path is the capture stem + .npz
    assert port_cli(["ingest", cap]) == 0
    assert (tmp_path / "cap.npz").exists()


@pytest.mark.parametrize("argv", [
    ["ingest", "{tmp}/missing.csv"],                       # unreadable file
    ["ingest", "{tmp}/bad.csv"],                           # bad row
    ["ingest", "{tmp}/cap.csv", "--stage", "nosuch:x=1"],  # unknown stage
    ["ingest", "{tmp}/cap.csv", "--stage", "clip:junk"],   # bad k=v syntax
    ["ingest", "{tmp}/cap.csv", "--stage",
     "filter:min_payload=9999"],                           # empty result
])
def test_cli_ingest_malformed_input_exits_2(tmp_path, argv, capsys):
    _write(tmp_path / "cap.csv", CSV_HEADER + "\n0.0,0,1,64\n")
    _write(tmp_path / "bad.csv", CSV_HEADER + "\n0.0,0,oops,64\n")
    rc = port_cli([a.format(tmp=tmp_path) for a in argv])
    assert rc == 2
    assert "python -m repro_torch ingest:" in capsys.readouterr().err


# --------------------------------------------------------------------------
# merge validation (traces/base.py)
# --------------------------------------------------------------------------

def _mini(name, port, gbps=100.0):
    return Trace(name, np.array([0.0]), np.array([port], np.int32),
                 np.array([port], np.int32), np.array([64], np.int64),
                 n_ports=port + 1, link_gbps=gbps)


def test_merge_rejects_mismatched_inputs():
    with pytest.raises(ValueError) as e:
        merge("m", [_mini("a", 0, gbps=100.0), _mini("b", 1, gbps=25.0)],
              n_ports=2, link_gbps=100.0)
    assert "100" in str(e.value) and "25" in str(e.value) and "'b'" in str(e.value)
    with pytest.raises(ValueError) as e:
        merge("m", [_mini("a", 1), _mini("b", 1)], n_ports=4)
    assert "port id 1" in str(e.value)
