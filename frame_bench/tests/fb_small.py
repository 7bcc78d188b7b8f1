"""Small versions of the cells for the CPU tests: the configurations'
geometry at a few hundred to a few thousand triangles, 96x72 frames, and
the mixes with short periods, so that a whole run takes seconds; and a
textured configuration, the structured scene's 36k build with its
``map_Kd`` images, for the OBJ part, ``shading`` and ``tex_filter``."""

import copy

from frame_bench import harness

WIDTH, HEIGHT = 96, 72


def config(name, full_frame=False):
    """The configuration with small geometry, and small frames unless
    ``full_frame``."""
    cfg = copy.deepcopy(harness.load_json("configs", name))
    if not full_frame:
        cfg["width"], cfg["height"] = WIDTH, HEIGHT
    for part in cfg["geometry"]:
        if part["kind"] == "grid_plane":
            part.update(nx=24, nz=24)
        elif part["kind"] == "uv_sphere":
            part.update(nu=24, nv=12)
    cfg["triangles"] = None
    return cfg


def textured(tex_filter="trilinear", shading="textures"):
    """The structured scene's 36k build (objgen's ``ensure_textured_scene``
    sizes and MTL) at 96x72 from the suite's spawn, textured."""
    lights = harness.load_json("configs", "san_miguel")["lights"]
    return {"name": "structured_tex", "width": WIDTH, "height": HEIGHT,
            "lights": lights,
            "camera": {"spawn": [13.566635, 4.0, 24.0],
                       "interactive": "walk"},
            "shading": shading, "tex_filter": tex_filter, "cell": 8,
            "geometry": [{"kind": "structured_obj", "terrain_n": 120,
                          "statue_nu": 80, "statue_nv": 44, "ruins": 40,
                          "size": 60.0, "mtl": "structured_tex"}],
            "triangles": 36322}


def traffic(name):
    t = copy.deepcopy(harness.load_json("traffic", name))
    if t["loop"] == "batch":
        t.update(batch=8, trace_units=16)
        t["camera"]["period_s"] = 0.5
    else:
        t.update(warm_ticks=8, trace_units=40, flush_interval=8)
        # A fast orbit: a short revolution for set-up's pass, and frames
        # that differ from tick to tick at this size.
        t["camera"]["orbit"]["speed"] = 20.0
        for seg in t["camera"]["walk"]["segments"]:
            seg["ticks"] = max(2, seg["ticks"] // 10)
    t["samples"] = 4
    return t


def bench(cell_name):
    """A BENCHMARK.json with one cell and every metric of the real one."""
    real = harness.load_bench()
    config_name, traffic_name = cell_name.split(".")
    return {"workloads": [{"name": cell_name, "config": config_name,
                           "traffic": traffic_name, "chips": 1}],
            "end_to_end": [dict(m, workloads=[cell_name])
                           for m in real["end_to_end"]
                           if "workloads" not in m
                           or traffic_name in str(m["workloads"])],
            "per_layer": [dict(m, workloads=[cell_name])
                          for m in real["per_layer"]
                          if "workloads" not in m
                          or traffic_name in str(m["workloads"])]}


def run(cell_name, seed=2_400_000_017, seconds=0.5, trace=0, bad_px=0,
        full_frame=False, traffic_changes=None, cfg=None, units=None):
    """A whole run of the cell's small version on the CPU (``cfg`` in
    place of the configuration's, ``units`` frames or ticks in place of
    ``seconds``)."""
    config_name, traffic_name = cell_name.split(".")
    cfg = cfg or config(config_name, full_frame)
    mix = traffic(traffic_name)
    (traffic_changes or (lambda t: None))(mix)
    return harness.run(cell_name, seed, seconds, trace,
                       bench=bench(cell_name), config=cfg, traffic=mix,
                       limits={"bad_px": bad_px}, device="cpu", units=units)
