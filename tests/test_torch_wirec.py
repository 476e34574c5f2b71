"""The port's wire extension (``native/wirec.c`` as ``_wirec_torch``) held
function by function against the JAX package's ``_wirec``, and its loader.

The same bodies (the golden fixtures of ``tests/golden`` and bodies made
from numpy seeds) go through both extensions: the parsed views, the
Prioritize and Filter encoders, the universe cache and the encoders over
a universe must give the same values and bytes, or raise the same error.
Both extensions load in one process; an object of one is refused by the
other's functions.  Skips only where ``tests/test_wirec.py`` does: without
a C compiler."""

import hashlib
import json
import sysconfig
from pathlib import Path

import numpy as np
import pytest

from platform_aware_scheduling_tpu.native import get_wirec as get_jax_wirec
from platform_aware_scheduling_tpu_torch import native

GOLDEN = Path(__file__).resolve().parent / "golden"
NAME_POOL = (
    [f"node-{i:03d}" for i in range(48)]
    + ['no"de-q', "no\\de-b", "node\t-t", "nöde-ü", "节点-一", "n💡de", "", " ", "x" * 300]
)


@pytest.fixture(scope="module")
def mods():
    """(the port's extension, the JAX one); skips without a compiler."""
    port, jax = native.get_wirec(), get_jax_wirec()
    if port is None or jax is None:
        pytest.skip("no C toolchain for the wire extensions")
    return port, jax


def seeded_body(rng, nodes_mode: bool, n: int) -> bytes:
    names = [NAME_POOL[i] for i in rng.integers(0, len(NAME_POOL), size=n)]
    labels = {}
    roll = rng.random()
    if roll < 0.8:
        labels["telemetry-policy"] = str(rng.choice(["pol", "other", 'p"ol', "pöl"]))
    elif roll < 0.9:
        labels["zz"] = "y"
    pod = {"metadata": {"name": str(rng.choice(["p", "", "p二"])), "namespace": "default", "labels": labels}}
    body = {"Pod": pod}
    if nodes_mode:
        body["Nodes"] = {"items": [{"metadata": {"name": name}} for name in names]}
    else:
        body["NodeNames"] = names
    return json.dumps(body, ensure_ascii=bool(rng.random() < 0.5)).encode()


def corpus():
    bodies = [p.read_bytes() for p in sorted(GOLDEN.glob("*.json"))]
    rng = np.random.default_rng(9)
    for i in range(60):
        bodies.append(seeded_body(rng, nodes_mode=i % 2 == 0, n=int(rng.integers(0, 40))))
    # the scanner's refusals must agree too: truncated and flipped bodies
    for body in list(bodies[:20]):
        cut = int(rng.integers(1, max(2, len(body))))
        bodies.append(body[:cut])
        flipped = bytearray(body)
        flipped[int(rng.integers(0, len(body)))] = int(rng.integers(0, 256))
        bodies.append(bytes(flipped))
    return bodies


CORPUS = corpus()


def outcome(fn, *args):
    """fn's result, or the name of the exception it raised."""
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001 — the exception type is the outcome
        return ("raised", type(exc).__name__)


def parsed_view(mod, body):
    parsed = outcome(mod.parse_prioritize, body)
    if isinstance(parsed, tuple):
        return parsed
    return (
        parsed.pod_name,
        parsed.pod_namespace,
        parsed.policy_label,
        parsed.nodes_present,
        parsed.num_nodes,
        parsed.node_names_present,
        parsed.num_node_names,
        outcome(parsed.node_names),
        outcome(parsed.node_names_list),
        parsed.nodes_span(),
        parsed.node_names_span(),
    )


def test_both_extensions_load_side_by_side(mods):
    port, jax = mods
    assert (port.__name__, jax.__name__) == ("_wirec_torch", "_wirec")
    assert type(port.build_table(["a"])).__name__ == type(jax.build_table(["a"])).__name__ == "NameTable"
    assert type(port.build_table(["a"])) is not type(jax.build_table(["a"]))
    assert port.UniverseCache is not jax.UniverseCache


@pytest.mark.parametrize("index", range(len(CORPUS)))
def test_parse_prioritize_equals_jax(mods, index):
    port, jax = mods
    assert parsed_view(port, CORPUS[index]) == parsed_view(jax, CORPUS[index])


def encoder_inputs(rng, n_table: int):
    names = list(dict.fromkeys(NAME_POOL[: n_table]))
    ranked = np.ascontiguousarray(rng.permutation(len(names)).astype(np.int64))
    planned = int(rng.integers(-1, len(names)))
    mask = (rng.random(len(names)) < 0.3).astype(np.uint8).tobytes()
    reasons = [json.dumps(f"policy pol: metric m={i}").encode() if rng.random() < 0.7 else None for i in range(len(names))]
    return names, ranked, planned, mask, reasons


@pytest.mark.parametrize("index", range(len(CORPUS)))
def test_encoders_equal_jax(mods, index):
    """select_encode and filter_encode over both name tables, in both
    candidate modes, with a seeded ranking, plan, mask and reasons."""
    port, jax = mods
    rng = np.random.default_rng(index)
    names, ranked, planned, mask, reasons = encoder_inputs(rng, int(rng.integers(1, len(NAME_POOL))))
    body = CORPUS[index]
    results = []
    for mod in (port, jax):
        parsed = outcome(mod.parse_prioritize, body)
        if isinstance(parsed, tuple):
            results.append(parsed)
            continue
        table = mod.build_table(names)
        results.append(
            [outcome(mod.select_encode, parsed, table, ranked, planned, use) for use in (False, True)]
            + [outcome(mod.filter_encode, parsed, table, mask, reasons), outcome(mod.filter_encode, parsed, table, mask)]
        )
    assert results[0] == results[1]


def test_universe_cache_and_its_encoders_equal_jax(mods):
    """The same request sequence through both universe caches (capacity
    2): the same probe outcomes (interned on the second sighting, MRU
    eviction) and, over each universe, the same bytes as the JAX
    extension's encoders."""
    port, jax = mods
    rng = np.random.default_rng(3)
    bodies = [seeded_body(rng, nodes_mode=False, n=30) for _ in range(4)]
    bodies += [seeded_body(rng, nodes_mode=True, n=12)]
    names, ranked, planned, mask, reasons = encoder_inputs(rng, len(NAME_POOL))
    sequence = [0, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 4, 4, 1]
    seen = {}
    for mod in (port, jax):
        cache, table = mod.UniverseCache(capacity=2), mod.build_table(names)
        out = []
        for i in sequence:
            parsed = mod.parse_prioritize(bodies[i])
            use_nn = parsed.node_names_present
            universe, interned, evicted = cache.probe(parsed, use_nn)
            step = [universe is None, interned, evicted, cache.occupancy]
            if universe is not None:
                step += [
                    universe.num,
                    universe.names(),
                    mod.select_encode_universe(universe, table, ranked, planned),
                    outcome(mod.filter_respond, universe, table, mask, reasons),
                ]
                # the universe's bytes equal the per-request encoders'
                assert step[-2] == mod.select_encode(parsed, table, ranked, planned, use_nn)
                if use_nn:
                    assert step[-1] == mod.filter_encode(parsed, table, mask, reasons)
            out.append(step)
        seen[mod.__name__] = (out, [{k: v for k, v in u.items() if k != "uid"} for u in cache.universes()])
    assert seen["_wirec_torch"] == seen["_wirec"]


def test_objects_of_one_extension_are_refused_by_the_other(mods):
    port, jax = mods
    body = CORPUS[0]
    ranked = np.arange(3, dtype=np.int64)
    with pytest.raises(TypeError):
        port.select_encode(jax.parse_prioritize(body), port.build_table(["a", "b", "c"]), ranked)
    with pytest.raises(TypeError):
        port.select_encode(port.parse_prioritize(body), jax.build_table(["a", "b", "c"]), ranked)
    with pytest.raises(TypeError):
        port.UniverseCache(capacity=1).probe(jax.parse_prioritize(body), False)


# -- the loader ------------------------------------------------------------------


def test_artifact_lands_in_the_ignored_build_directory(mods):
    path = native.so_path()
    digest = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:16]
    repo = Path(native.__file__).resolve().parents[2]
    assert path.parent == repo / "build" / "native"
    assert path.name == f"_wirec_torch-{digest}-{sysconfig.get_config_var('SOABI')}.so"
    assert path.is_file()
    ignored = (repo / ".gitignore").read_text().split()
    assert "build/" in ignored, "build/ is not in .gitignore"
    assert not list(native.SOURCE.parent.glob("*.so")), "the loader wrote into the package"


def test_no_native_switch_gives_none(mods, monkeypatch):
    monkeypatch.setenv("PAS_TPU_NO_NATIVE", "1")
    assert native.get_wirec() is None
    monkeypatch.delenv("PAS_TPU_NO_NATIVE")
    assert native.get_wirec() is mods[0]


def fresh_loader(monkeypatch, tmp_path, source=None):
    monkeypatch.setattr(native, "_loaded", False)
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    if source is not None:
        monkeypatch.setattr(native, "SOURCE", source)


def test_build_keyed_by_source_hash_and_abi(mods, monkeypatch, tmp_path):
    """A fresh build directory: the first call builds the artifact there
    and loads it; a stale artifact of another source is removed."""
    fresh_loader(monkeypatch, tmp_path)
    (tmp_path / "native").mkdir()
    stale = tmp_path / "native" / "_wirec_torch-0000000000000000-old.so"
    stale.write_bytes(b"")
    module = native.get_wirec()
    assert module is not None and module.__file__ == str(native.so_path())
    assert native.so_path().parent == tmp_path / "native"
    assert not stale.exists()
    assert module.parse_prioritize(CORPUS[0]).policy_label == mods[0].parse_prioritize(CORPUS[0]).policy_label


def test_a_failed_build_gives_none_and_prints_the_compiler(mods, monkeypatch, tmp_path, capsys):
    broken = tmp_path / "wirec.c"
    broken.write_text("this is not C\n")
    fresh_loader(monkeypatch, tmp_path, source=broken)
    assert native.get_wirec() is None
    assert "_wirec_torch build failed" in capsys.readouterr().err
    assert not list((tmp_path / "native").glob("*.tmp"))


def test_explicit_artifact_override(mods, monkeypatch, tmp_path):
    """PAS_TPU_WIREC_SO loads exactly the given artifact, and raises when
    it cannot be loaded."""
    fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("PAS_TPU_WIREC_SO", mods[0].__file__)
    assert native.get_wirec().__file__ == mods[0].__file__
    fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("PAS_TPU_WIREC_SO", str(tmp_path / "missing.so"))
    with pytest.raises((ImportError, OSError, FileNotFoundError)):
        native.get_wirec()
