"""Traversal preview + manual selection tool (stage-2 companion); port of
`mtgs_tpu/tools/preview.py` (the same page, byte for byte, on the same dict).

Equivalent of the reference's streamlit apps
(`nuplan_scripts/preview.py` — trajectory plots over the road block with
per-video frame-range selection — and `nuplan_scripts/filter_trajectory.py`
— applying `selected_videos` to produce the filtered stage). Without
streamlit or the nuPlan map API as dependencies, the preview is a
dependency-free standalone HTML file: an SVG plot of every traversal's
ego trajectory with per-video checkboxes, frame-range inputs, live
highlighting, and an export box that emits the `selected_videos` list in
the road-block config format (`idx` or `{idx, start_frame, end_frame}`).

CLI:
    python -m mtgs_torch.tools.preview DATA_ROOT SCENE_NAME [--out preview.html]
    python -m mtgs_torch.tools.preview DATA_ROOT SCENE_NAME \
        --apply '[1, {"idx": 3, "start_frame": 0, "end_frame": 50}]'
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from mtgs_torch.preprocess.video_scene import FILTERS, VideoScene

_COLORS = [
    "#3366cc", "#dc3912", "#ff9900", "#109618", "#990099", "#0099c6",
    "#dd4477", "#66aa00", "#b82e2e", "#316395", "#994499", "#22aa99",
]


def trajectory_xy(info: dict) -> np.ndarray:
    """Per-frame global ego xy for one video, whatever the stage schema.

    Frame records carry `ego2global` (4x4, post-registration) or
    `ego2global_translation` / `can_bus[0:3]` (raw stage).
    """
    pts = []
    for f in info.get("frame_infos", []):
        if "ego2global" in f:
            pts.append(np.asarray(f["ego2global"], np.float64)[:2, 3])
        elif "ego2global_translation" in f:
            pts.append(np.asarray(f["ego2global_translation"], np.float64)[:2])
        elif "can_bus" in f:
            pts.append(np.asarray(f["can_bus"][0:2], np.float64))
    return np.asarray(pts).reshape(-1, 2)


def build_preview_html(
    video_scene_dict: dict,
    out_path: str | Path,
    *,
    selected: Sequence = (),
    road_block: Optional[Sequence[float]] = None,
) -> Path:
    """Write a standalone interactive preview; returns the path.

    Args:
        selected: initial `selected_videos` entries (ints or dicts).
        road_block: optional (x_min, y_min, x_max, y_max) rectangle.
    """
    trajs: Dict[int, np.ndarray] = {}
    nframes: Dict[int, int] = {}
    for token, info in video_scene_dict.items():
        idx = int(str(token).split("-")[-1])
        xy = trajectory_xy(info)
        if len(xy):
            trajs[idx] = xy
            nframes[idx] = len(info.get("frame_infos", []))
    if not trajs:
        raise ValueError("no trajectories in video_scene_dict")

    allxy = np.concatenate(list(trajs.values()))
    lo, hi = allxy.min(0), allxy.max(0)
    if road_block is not None:
        lo = np.minimum(lo, np.asarray(road_block[:2], np.float64))
        hi = np.maximum(hi, np.asarray(road_block[2:], np.float64))
    span = np.maximum(hi - lo, 1e-6)
    size, pad = 760.0, 30.0
    scale = (size - 2 * pad) / span.max()

    def sx(x):
        return pad + (x - lo[0]) * scale

    def sy(y):  # flip y so north is up
        return size - pad - (y - lo[1]) * scale

    sel_init = {}
    for s in selected:
        if isinstance(s, dict):
            sel_init[int(s["idx"])] = [
                int(s.get("start_frame", 0)),
                int(s.get("end_frame", nframes.get(int(s["idx"]), 0))),
            ]
        else:
            sel_init[int(s)] = [0, nframes.get(int(s), 0)]

    data = {
        str(i): {
            "pts": [[round(float(sx(p[0])), 2), round(float(sy(p[1])), 2)]
                    for p in xy],
            "n": nframes[i],
            "color": _COLORS[k % len(_COLORS)],
        }
        for k, (i, xy) in enumerate(sorted(trajs.items()))
    }

    rect = ""
    if road_block is not None:
        x0, y0 = sx(road_block[0]), sy(road_block[3])
        w = (road_block[2] - road_block[0]) * scale
        h = (road_block[3] - road_block[1]) * scale
        rect = (f'<rect x="{x0:.1f}" y="{y0:.1f}" width="{w:.1f}" '
                f'height="{h:.1f}" fill="none" stroke="#888" '
                'stroke-dasharray="6 4"/>')

    page = f"""<!doctype html><html><head><meta charset="utf-8">
<title>MTGS traversal preview</title><style>
body{{font-family:system-ui,sans-serif;display:flex;gap:16px;margin:16px}}
svg{{border:1px solid #ccc;background:#fafafa}}
table{{border-collapse:collapse;font-size:13px}}
td,th{{padding:3px 8px;border-bottom:1px solid #eee;text-align:left}}
input[type=number]{{width:60px}}
textarea{{width:100%;height:120px;font-family:monospace;font-size:12px}}
.sw{{display:inline-block;width:12px;height:12px;border-radius:2px;margin-right:4px}}
</style></head><body>
<svg id="map" width="{size:.0f}" height="{size:.0f}">{rect}</svg>
<div style="min-width:420px">
<h3>Traversals ({len(trajs)})</h3>
<table id="tbl"><tr><th></th><th>video</th><th>frames</th>
<th>start</th><th>end</th></tr></table>
<p><button onclick="exportSel()">Export selected_videos</button></p>
<textarea id="out" placeholder="selected_videos (paste into the road-block config)"></textarea>
</div>
<script>
const DATA = {json.dumps(data)};
const INIT = {json.dumps({str(k): v for k, v in sel_init.items()})};
const svg = document.getElementById("map"), tbl = document.getElementById("tbl");
function draw() {{
  svg.querySelectorAll("polyline,circle").forEach(e => e.remove());
  for (const [idx, d] of Object.entries(DATA)) {{
    const row = document.getElementById("row" + idx);
    const on = row.querySelector("input[type=checkbox]").checked;
    const s = +row.querySelector(".s").value, e = +row.querySelector(".e").value;
    const mk = (pts, w, op) => {{
      if (pts.length < 2) return;
      const pl = document.createElementNS("http://www.w3.org/2000/svg", "polyline");
      pl.setAttribute("points", pts.map(p => p.join(",")).join(" "));
      pl.setAttribute("fill", "none"); pl.setAttribute("stroke", d.color);
      pl.setAttribute("stroke-width", w); pl.setAttribute("opacity", op);
      svg.appendChild(pl);
    }};
    mk(d.pts, 1, on ? 0.25 : 0.12);
    if (on) {{
      mk(d.pts.slice(s, e), 2.5, 0.95);
      const c = document.createElementNS("http://www.w3.org/2000/svg", "circle");
      const p0 = d.pts[Math.min(s, d.pts.length - 1)];
      c.setAttribute("cx", p0[0]); c.setAttribute("cy", p0[1]);
      c.setAttribute("r", 4); c.setAttribute("fill", d.color);
      svg.appendChild(c);
    }}
  }}
}}
for (const [idx, d] of Object.entries(DATA)) {{
  const tr = document.createElement("tr"); tr.id = "row" + idx;
  const init = INIT[idx];
  tr.innerHTML = `<td><input type="checkbox" ${{init ? "checked" : ""}}></td>
<td><span class="sw" style="background:${{d.color}}"></span>${{idx}}</td>
<td>${{d.n}}</td>
<td><input type="number" class="s" min="0" max="${{d.n}}" value="${{init ? init[0] : 0}}"></td>
<td><input type="number" class="e" min="0" max="${{d.n}}" value="${{init ? init[1] : d.n}}"></td>`;
  tr.querySelectorAll("input").forEach(i => i.addEventListener("input", draw));
  tbl.appendChild(tr);
}}
function exportSel() {{
  const out = [];
  for (const [idx, d] of Object.entries(DATA)) {{
    const row = document.getElementById("row" + idx);
    if (!row.querySelector("input[type=checkbox]").checked) continue;
    const s = +row.querySelector(".s").value, e = +row.querySelector(".e").value;
    out.push(s === 0 && e === d.n ? +idx
             : {{idx: +idx, start_frame: s, end_frame: e}});
  }}
  document.getElementById("out").value =
      "selected_videos: " + JSON.stringify(out);
}}
draw();
</script></body></html>"""
    out_path = Path(out_path)
    out_path.write_text(page)
    return out_path


def filter_trajectory(
    video_scene: VideoScene, selected_videos: Sequence, *, stage: str = "filtered"
) -> dict:
    """Apply the manual selection and persist the filtered stage
    (ref `nuplan_scripts/filter_trajectory.py:29-36`)."""
    vsd = video_scene.load()
    vsd = FILTERS["filter_by_video_idx"](vsd, video_idxs=selected_videos)
    video_scene.save(vsd, stage)
    return vsd


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("scene_name")
    ap.add_argument("--out", default="preview.html")
    ap.add_argument("--apply", default=None,
                    help="JSON selected_videos list; applies the filter "
                         "and writes the 'filtered' stage instead of "
                         "building the preview")
    args = ap.parse_args(argv)
    vs = VideoScene(args.data_root, args.scene_name)
    if args.apply is not None:
        vsd = filter_trajectory(vs, json.loads(args.apply))
        print(f"filtered stage written: {len(vsd)} videos kept")
        return 0
    path = build_preview_html(vs.load(), args.out)
    print(f"preview written to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
