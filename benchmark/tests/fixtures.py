"""Small cells for the CPU tests: the manifest's configurations cut to a
frame of a few tiles, a small atlas and cube, and mixes with a few frames
of warm-up, written into a directory the harness searches."""

from __future__ import annotations

import json
import os

from benchmark import harness

TINY_RENDER = dict(width=192, height=112, shadow_size=128, env_size=64)


def write_tiny(root: str, cubes: int = 30) -> dict:
    """Tiny copies of every configuration and mix under ``root``
    (``configs``, ``traffic``, ``limits``) and the manifest of their cells
    (``tiny_<config>.<mix>``); returns the manifest."""
    man = harness._load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    configs = []
    for entry in man["configs"]:
        c = harness._load_json(os.path.join(harness.ROOT, entry["file"]))
        name = "tiny_" + entry["name"]
        c["name"] = name
        c["render"].update(TINY_RENDER)
        if "grid" in c["scene"]:
            c["scene"]["grid"]["cubes"] = cubes
        with open(os.path.join(root, "configs", name + ".json"), "w") as f:
            json.dump(c, f)
        configs.append(dict(entry, name=name, file="none/" + name + ".json"))
    mixes = {w["traffic"] for w in man["workloads"]}
    for mix in mixes:
        m = harness._load_json(os.path.join(harness.BENCH_DIR, "traffic",
                                            mix + ".json"))
        m["warmup_frames"] = 2
        with open(os.path.join(root, "traffic", "tiny_" + mix + ".json"), "w") as f:
            json.dump(m, f)
    workloads = [dict(w, name=f"tiny_{w['config']}.{w['traffic']}",
                      config="tiny_" + w["config"],
                      traffic="tiny_" + w["traffic"])
                 for w in man["workloads"]]
    names = {w["name"]: f"tiny_{w['config']}.{w['traffic']}"
             for w in man["workloads"]}
    for w in man["workloads"]:
        src = os.path.join(harness.BENCH_DIR, "limits", w["name"] + ".json")
        if os.path.exists(src):
            with open(src) as f, open(os.path.join(
                    root, "limits", names[w["name"]] + ".json"), "w") as g:
                g.write(f.read())
    per_layer = [dict(m, workloads=[names[n] for n in m["workloads"]])
                 if "workloads" in m else m for m in man["per_layer"]]
    return dict(man, configs=configs, workloads=workloads, per_layer=per_layer)
