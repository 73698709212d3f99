"""Small cells for the CPU tests: the manifest's configurations cut to a
frame of a few tiles, a small atlas and cube, and mixes with a few frames
of warm-up, written into a directory the harness searches."""

from __future__ import annotations

import json
import math
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


def sphere_obj(stacks: int, slices: int) -> str:
    """The OBJ text of a unit UV sphere: the rows of ``stacks + 1`` rings of
    ``slices + 1`` vertices (the seam doubled), each vertex its own ``v``,
    ``vt`` and ``vn``, a triangle a face (none degenerate at the poles)."""
    lines, faces = [], []
    for i in range(stacks + 1):
        t = math.pi * i / stacks
        for j in range(slices + 1):
            p = 2.0 * math.pi * j / slices
            n = (math.sin(t) * math.cos(p), math.cos(t), math.sin(t) * math.sin(p))
            lines.append("v %.9g %.9g %.9g" % n)
            lines.append("vt %.9g %.9g" % (j / slices, i / stacks))
            lines.append("vn %.9g %.9g %.9g" % n)
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j + 1
            b = a + slices + 1
            if i > 0:
                faces.append((a, b, a + 1))
            if i < stacks - 1:
                faces.append((a + 1, b, b + 1))
    lines += ["f " + " ".join(f"{k}/{k}/{k}" for k in f) for f in faces]
    return "\n".join(lines) + "\n"


def write_obj_cell(root: str, mesh_path: str) -> dict:
    """A tiny cell of a level of two objects, a flat cube for the ground
    and a flat object of the mesh file ``mesh_path`` over it, under each
    mix (``tiny_obj.tiny_<mix>``, limits of ``deferred_1080p``'s cells),
    added to :func:`write_tiny`'s manifest; returns the manifest."""
    man = write_tiny(root, cubes=4)
    demo = harness._load_json(os.path.join(harness.BENCH_DIR, "levels",
                                           "demo.lvl"))
    camera = dict(demo["camera"], position=[-5.0, 4.0, 0.0],
                  orientation=[0.0, 0.0, -math.atan2(4.0, 5.0)])

    def flat(mesh, position, scale, albedo, roughness, metalness):
        return {"components": [{"Renderable": {
            "model_descriptor": {
                "material_descriptor": {"Flat": {
                    "albedo": albedo, "roughness": roughness,
                    "metalness": metalness}},
                "mesh_descriptor": mesh},
            "rendering_options": {"cast_shadows": True, "pass": "DeferredMain",
                                  "pbr_resource_type": "FlatParameters",
                                  "use_depth_test": True}}}],
            "transform": {"position": position, "rotation": [0.0, 0.0, 0.0, 1.0],
                          "scale": scale}}

    level = {"camera": camera,
             "omnipresent_objects": demo["omnipresent_objects"],
             "world_objects": [
                 flat({"PrimitiveInCode": "Cube"}, [0.0, -1.5, 0.0],
                      [4.0, 0.25, 4.0], [0.45, 0.45, 0.5], 0.9, 0.0),
                 flat({"FromFile": mesh_path}, [0.3, 0.2, -0.4],
                      [1.0, 1.0, 1.0], [0.8, 0.3, 0.2], 0.4, 0.1)]}
    level_path = os.path.join(root, "obj.lvl")
    with open(level_path, "w") as f:
        json.dump(level, f)
    c = harness._load_json(os.path.join(harness.BENCH_DIR, "configs",
                                        "deferred_1080p.json"))
    c.update(name="tiny_obj", scene={"level": level_path})
    c["render"].update(TINY_RENDER)
    with open(os.path.join(root, "configs", "tiny_obj.json"), "w") as f:
        json.dump(c, f)
    man["configs"].append(dict(man["configs"][0], name="tiny_obj",
                               file="none/tiny_obj.json"))
    for mix in ("orbit", "drag"):
        name = f"tiny_obj.tiny_{mix}"
        man["workloads"].append({"name": name, "config": "tiny_obj",
                                 "traffic": "tiny_" + mix, "chips": 1,
                                 "why": "a test"})
        with open(os.path.join(harness.BENCH_DIR, "limits",
                               f"deferred_1080p.{mix}.json")) as f, open(
                os.path.join(root, "limits", name + ".json"), "w") as g:
            g.write(f.read())
    return man
