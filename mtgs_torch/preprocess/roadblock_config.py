"""RoadBlockConfig: the YAML/py data-config layer shared by the offline
factory and the trainer; port of `mtgs_tpu/preprocess/roadblock_config.py`.

Mirror of the reference's scene-selection dataclasses
(`nuplan_scripts/utils/config.py:38-108` in OpenDriveLab/MTGS): a road
block is described once — name, UTM extent, city, traversal selection,
preprocessing switches — and both `preprocess.pipeline` and
`tools/train_scene` consume it. Loads three formats:

  * plain-mapping YAML (what `save_yaml` writes);
  * the reference's `!!python/object:nuplan_scripts.utils.config.
    RoadBlockConfig` tagged YAML (docs/prepare_dataset.md:56-81): the
    `!!python/object:` tags degrade to mappings and `!!python/tuple` to
    tuples, nothing is executed — the paper's shipped configs load
    unchanged;
  * a `.py` module exposing a `config` attribute.

The YAML reader and writer are the port's own (no PyYAML). The reader
takes block mappings and sequences (indentless sequences under a key,
`- - x`, `- key: v`), flow sequences and mappings on one line, plain,
single- and double-quoted scalars resolved as PyYAML's SafeLoader resolves
them (YAML 1.1: `yes`/`off` are booleans, `0123` is octal, `1e5` a string),
plain and single-quoted scalars folded over lines (as PyYAML writes a
long one), comments, one leading `---`, and the three tags above.
Anything else (anchors, aliases, block scalars, other tags, multi-line
double-quoted scalars or flow collections) raises ValueError naming the
line. The writer writes what `yaml.safe_dump(..., sort_keys=False)` writes,
long scalars folded at PyYAML's width.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple

CITIES = (
    "sg-one-north",
    "us-ma-boston",
    "us-nv-las-vegas-strip",
    "us-pa-pittsburgh-hazelwood",
)


@dataclasses.dataclass
class RoadBlockConfig:
    """Scene/data selection for one road block (`config.py:38-86`)."""

    road_block_name: str = ""
    # (x_min, y_min, x_max, y_max) UTM extent
    road_block: Tuple[float, ...] = ()
    city: str = "us-ma-boston"
    data_root: str = "./data/MTGS"
    interval: int = 1            # 1 -> 10 Hz
    expand_buffer: float = 0.0   # meters of trajectory expansion (lidar reg)
    reconstruct_buffer: float = 0.0  # meters of reconstruction buffer
    selected_videos: Tuple[Any, ...] = ()  # video idx or {idx, start, end}
    split: str = "trainval"      # nuplan DB split: trainval | test | all
    collect_raw: bool = False
    exclude_bad_registration: bool = True
    use_colmap_ba: bool = False
    # FrameCentral extension (`config.py:88-96`)
    central_log: str = ""
    central_tokens: List[str] = dataclasses.field(default_factory=list)
    multi_traversal_mode: str = "off"

    @property
    def scene_dir(self) -> Path:
        return Path(self.data_root) / self.road_block_name

    def to_stage_config(self) -> Dict[str, Any]:
        """Per-stage config dict for `preprocess.pipeline.run_pipeline`.
        As in the JAX package, `exclude_bad`, `use_colmap_ba` and `enabled`
        are carried but no stage reads them."""
        common = dict(
            road_block=tuple(self.road_block),
            interval=self.interval,
            expand_buffer=self.expand_buffer,
            reconstruct_buffer=self.reconstruct_buffer,
            selected_videos=tuple(self.selected_videos),
            split=self.split,
            city=self.city,
        )
        cfg: Dict[str, Any] = {name: dict(common) for name in (
            "video_split", "export_videos", "collect_raw", "semantic_masks",
            "lidar_registration", "colmap", "dense_depth", "stack_point_cloud",
        )}
        if self.central_tokens:
            cfg["video_split"]["central_token"] = self.central_tokens[0]
        cfg["lidar_registration"]["exclude_bad"] = self.exclude_bad_registration
        cfg["colmap"]["use_colmap_ba"] = self.use_colmap_ba
        cfg["collect_raw"]["enabled"] = self.collect_raw
        return cfg


def _from_mapping(d: Dict[str, Any]) -> RoadBlockConfig:
    fields = {f.name for f in dataclasses.fields(RoadBlockConfig)}
    known = {k: v for k, v in d.items() if k in fields}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown RoadBlockConfig keys: {sorted(unknown)}")
    cfg = RoadBlockConfig(**known)
    if isinstance(cfg.road_block, list):
        cfg.road_block = tuple(cfg.road_block)
    if isinstance(cfg.selected_videos, list):
        cfg.selected_videos = tuple(cfg.selected_videos)
    return cfg


# ------------------------------------------------------------------ YAML

# PyYAML's implicit resolvers (YAML 1.1), `yaml/resolver.py`
_NULL = {"~", "null", "Null", "NULL", ""}
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN)")
_OBJECT_TAGS = ("!!python/object:", "!!python/object/apply:")
_TUPLE_TAG = "!!python/tuple"


def _sexagesimal(text: str) -> float:
    value = 0.0
    for part in text.split(":"):
        value = value * 60 + float(part)
    return value


def _resolve_plain(text: str) -> Any:
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if ":" in v:
            return sign * int(_sexagesimal(v))
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v)
        return sign * float(v)
    return text


class _Lines:
    """The document's content lines: (line number, indent, text)."""

    def __init__(self, text: str, source: str):
        self.source = source
        self.rows: List[Tuple[int, int, str]] = []
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise self.error(no, "a tab in the indentation")
            body = raw.strip()
            if not body or body.startswith("#"):
                continue
            self.rows.append((no, len(raw) - len(raw.lstrip(" ")), body))

    def error(self, line: int, what: str) -> ValueError:
        return ValueError(f"{self.source}:{line}: unsupported YAML: {what}")


def _strip_comment(text: str) -> str:
    m = re.search(r"(^|\s)#", text)
    return text[: m.start()].rstrip() if m else text


def _quoted(text: str, lines: _Lines, no: int) -> Tuple[str, str]:
    """A quoted scalar at the start of `text` -> (value, the rest)."""
    q = text[0]
    i, out = 1, []
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            if i + 1 >= len(text):
                break
            e = text[i + 1]
            simple = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "\\": "\\", '"': '"', "/": "/",
                      " ": " ", "a": "\a", "b": "\b", "e": "\x1b", "f": "\f", "v": "\v"}
            if e in simple:
                out.append(simple[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None or len(text) < i + 2 + width:
                raise lines.error(no, f"the escape \\{e}")
            out.append(chr(int(text[i + 2: i + 2 + width], 16)))
            i += 2 + width
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise lines.error(no, "a quoted scalar that does not end on its line")


def _scalar(text: str, lines: _Lines, no: int) -> Any:
    """An inline value: a quoted or plain scalar, or a flow collection."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lines, no)
        if _strip_comment(rest).strip():
            raise lines.error(no, f"text after a quoted scalar: {rest.strip()!r}")
        return value
    if text[:1] in ("[", "{"):
        value, rest = _flow(text, lines, no)
        if _strip_comment(rest).strip():
            raise lines.error(no, f"text after a flow collection: {rest.strip()!r}")
        return value
    if text[:1] in ("&", "*", "|", ">", "%", "@", "`", "!") or re.match(r"[?:](\s|$)", text):
        raise lines.error(no, f"{text!r} (anchors, aliases, block scalars, tags and "
                              "directives are not read)")
    return _resolve_plain(_strip_comment(text))


def _flow_value(text: str, lines: _Lines, no: int) -> Tuple[Any, str]:
    """A value inside a flow collection -> (value, rest)."""
    if text[:1] in ("[", "{"):
        return _flow(text, lines, no)
    if text[:1] in ("'", '"'):
        return _quoted(text, lines, no)
    m = re.match(r"[^,\]}]*", text)
    return _resolve_plain(m.group(0).strip()), text[m.end():]


def _flow(text: str, lines: _Lines, no: int) -> Tuple[Any, str]:
    """A flow sequence or mapping at the start of `text` -> (value, rest)."""
    close = "]" if text[0] == "[" else "}"
    out: Any = [] if close == "]" else {}
    rest = text[1:].lstrip()
    while True:
        if not rest:
            raise lines.error(no, "a flow collection that does not end on its line")
        if rest[0] == close:
            return out, rest[1:]
        if close == "]":
            item, rest = _flow_value(rest, lines, no)
            out.append(item)
        else:
            if rest[0] in "'\"":
                key, rest = _quoted(rest, lines, no)
            else:
                m = re.match(r"[^,:\]}]*", rest)
                key, rest = _resolve_plain(m.group(0).strip()), rest[m.end():]
            rest = rest.lstrip()
            if rest[:1] != ":":
                raise lines.error(no, f"a flow mapping entry without a value: {rest!r}")
            out[key], rest = _flow_value(rest[1:].lstrip(), lines, no)
        rest = rest.lstrip()
        if rest[:1] == ",":
            rest = rest[1:].lstrip()
        elif rest[:1] != close:
            raise lines.error(no, f"{rest!r} in a flow collection")


_KEY = re.compile(r"""(?:'(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^'"#\s][^#]*?)\s*:(?:\s|$)""")


def _split_tag(text: str, lines: _Lines, no: int) -> Tuple[str | None, str]:
    if not text.startswith("!"):
        return None, text
    tag, _, rest = text.partition(" ")
    if tag != _TUPLE_TAG and not tag.startswith(_OBJECT_TAGS):
        raise lines.error(no, f"the tag {tag}")
    return tag, rest.strip()


def _tagged(tag: str | None, value: Any, lines: _Lines, no: int) -> Any:
    if tag is None:
        return value
    if tag == _TUPLE_TAG:
        if not isinstance(value, list):
            raise lines.error(no, f"{tag} on a {type(value).__name__}")
        return tuple(value)
    if not isinstance(value, dict):
        raise lines.error(no, f"{tag} on a {type(value).__name__}")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, lines: _Lines):
        self.lines = lines
        self.rows = lines.rows
        self.i = 0

    def node(self, indent: int) -> Any:
        no, col, text = self.rows[self.i]
        if _is_item(text):
            return self.sequence(col)
        if _KEY.match(text):
            return self.mapping(col)
        self.i += 1
        return self.scalar(text, indent, no)

    def scalar(self, text: str, indent: int, no: int) -> Any:
        """An inline value. A plain or single-quoted scalar goes on over the
        lines indented past `indent` that follow it, each line break read as
        one space (YAML's line folding, as PyYAML writes long scalars)."""
        def more() -> bool:
            if self.i >= len(self.rows) or self.rows[self.i][1] <= indent:
                return False
            nxt = self.rows[self.i][2]
            if _is_item(nxt) or _KEY.match(nxt):
                raise self.lines.error(self.rows[self.i][0], "unexpected indentation")
            return True

        def closed(t: str) -> bool:
            try:
                _quoted(t, self.lines, no)
                return True
            except ValueError:
                return False

        if text[:1] == "'":
            while not closed(text) and more():
                text += " " + self.rows[self.i][2]
                self.i += 1
        elif text[:1] not in ('"', "[", "{") and _strip_comment(text) == text:
            while more():
                nxt = self.rows[self.i][2]
                text += " " + nxt
                self.i += 1
                if _strip_comment(nxt) != nxt:
                    break
        return _scalar(text, self.lines, no)

    def child(self, indent: int, no: int, tag: str | None, allow_indentless: bool) -> Any:
        """The block value of a key or an item ending at line `no`."""
        if self.i < len(self.rows):
            _, col, text = self.rows[self.i]
            if col > indent or (allow_indentless and col == indent and _is_item(text)):
                return _tagged(tag, self.node(col), self.lines, no)
        return _tagged(tag, None, self.lines, no) if tag else None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.rows):
            no, col, text = self.rows[self.i]
            if col != indent or not _is_item(text):
                break
            body = text[1:].lstrip()
            tag, body = _split_tag(body, self.lines, no)
            if not body:
                self.i += 1
                out.append(self.child(indent, no, tag, allow_indentless=False))
                continue
            # the item's text is a node of its own at its column
            self.rows[self.i] = (no, col + len(text) - len(body), body)
            out.append(_tagged(tag, self.node(col + 1), self.lines, no))
        return out

    def mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while self.i < len(self.rows):
            no, col, text = self.rows[self.i]
            if col != indent:
                if col > indent:
                    raise self.lines.error(no, "unexpected indentation (a multi-line scalar?)")
                break
            if _is_item(text):
                break
            m = _KEY.match(text)
            if not m:
                raise self.lines.error(no, f"{text!r} where a mapping key was expected")
            key_text = text[: m.end()].rstrip()[:-1].rstrip()
            key = _scalar(key_text, self.lines, no)
            if key in out:
                raise self.lines.error(no, f"the key {key!r} twice")
            tag, rest = _split_tag(text[m.end():].strip(), self.lines, no)
            self.i += 1
            if rest and not rest.startswith("#"):
                out[key] = _tagged(tag, self.scalar(rest, indent, no), self.lines, no)
            else:
                out[key] = self.child(indent, no, tag, allow_indentless=True)
        return out


def yaml_load(text: str, source: str = "<yaml>") -> Any:
    """The port's YAML reader (see the module docstring for what it takes)."""
    lines = _Lines(text, source)
    rows = lines.rows
    if rows and rows[0][2].startswith("---"):
        no, col, body = rows[0]
        if body[3:].strip():
            rows[0] = (no, col, body[3:].strip())
        else:
            rows.pop(0)
    tag = tag_line = None
    if rows and rows[0][2].startswith("!"):  # the document's own tag
        no, col, body = rows[0]
        tag, body = _split_tag(body, lines, no)
        tag_line = no
        if body:
            rows[0] = (no, col, body)
        else:
            rows.pop(0)
    value = None
    if rows:
        parser = _Parser(lines)
        value = parser.node(rows[0][1])
        if parser.i < len(rows):
            no, _, body = rows[parser.i]
            raise lines.error(no, f"{body!r} after the document's end")
    return _tagged(tag, value, lines, tag_line)


BEST_WIDTH = 80  # PyYAML's default line width


def _fold(text: str, column: int, indent: int, quoted: bool) -> str:
    """PyYAML's `Emitter.write_plain` / `write_single_quoted`: a single space
    after a word that ends past BEST_WIDTH becomes a line break and `indent`
    spaces (inside quotes, not at the text's edges)."""
    out = ["'"] if quoted else []
    column += quoted
    spaces = False
    start = end = 0
    while end <= len(text):
        ch = text[end] if end < len(text) else None
        if spaces:
            if ch != " ":
                if (start + 1 == end and column > BEST_WIDTH
                        and (not quoted or (start != 0 and end != len(text)))):
                    out.append("\n" + " " * indent)
                    column = indent
                else:
                    out.append(text[start:end])
                    column += end - start
                start = end
        elif ch is None or ch == " " or (quoted and ch == "'"):
            out.append(text[start:end])
            column += end - start
            start = end
        if quoted and ch == "'":
            out.append("''")
            column += 2
            start = end + 1
        if ch is not None:
            spaces = ch == " "
        end += 1
    return "".join(out) + ("'" if quoted else "")


def _dump_scalar(v: Any, column: int = 0, indent: int = 0) -> str:
    """One scalar as PyYAML writes it starting at `column`, a folded line
    going on at `indent`."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        # PyYAML's rules for a plain scalar in block context (emitter.analyze_scalar)
        plain = (v and v == v.strip() and v.isprintable() and isinstance(_resolve_plain(v), str)
                 and v[0] not in "#,[]{}&*!|>'\"%@`" and not re.match(r"[-?:](\s|$)", v)
                 and ": " not in v and " #" not in v and not v.endswith(":"))
        if plain or v.isprintable():
            return _fold(v, column, indent, quoted=not plain)
        return json.dumps(v)
    raise TypeError(f"save_yaml: cannot write a {type(v).__name__} ({v!r})")


def _dump_block(obj: Any, indent: int) -> List[str]:
    pad = " " * indent
    out: List[str] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = pad + _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(key + ":")
                out += _dump_block(v, indent + 2)
            elif isinstance(v, (list, tuple)) and v:
                out.append(key + ":")
                out += _dump_block(v, indent)  # an indentless sequence, as PyYAML writes it
            else:
                out.append(key + ": " + _dump_inline(v, len(key) + 2, indent + 2))
        return out
    for item in obj:
        if isinstance(item, (dict, list, tuple)) and item:
            sub = _dump_block(item, indent + 2)
            out.append(pad + "- " + sub[0][indent + 2:])
            out += sub[1:]
        else:
            out.append(pad + "- " + _dump_inline(item, indent + 2, indent + 2))
    return out


def _dump_inline(v: Any, column: int, indent: int) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v, column, indent)


def yaml_dump(mapping: Dict[str, Any]) -> str:
    """A mapping as block YAML, in the layout `yaml.safe_dump(mapping,
    sort_keys=False)` writes (tuples as sequences)."""
    return "\n".join(_dump_block(mapping, 0)) + "\n"


def load_road_block_config(path: str | os.PathLike) -> RoadBlockConfig:
    """Load a RoadBlockConfig from .yaml/.yml/.py (the reference's
    `load_config`, `config.py:98-108`)."""
    path = Path(path)
    if path.suffix == ".py":
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)  # type: ignore[union-attr]
        cfg = mod.config
        if isinstance(cfg, RoadBlockConfig):
            return cfg
        if dataclasses.is_dataclass(cfg):
            return _from_mapping(dataclasses.asdict(cfg))
        return _from_mapping(dict(cfg))
    if path.suffix in (".yml", ".yaml"):
        data = yaml_load(path.read_text(), str(path))
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a mapping, got {type(data)}")
        return _from_mapping(data)
    raise ValueError(f"unsupported config suffix: {path.suffix}")


def save_yaml(cfg: RoadBlockConfig, path: str | os.PathLike) -> None:
    """Write the config as plain-mapping YAML (loadable by safe_load —
    no python tags, unlike the reference's `BaseConfig.save_config`)."""
    d = dataclasses.asdict(cfg)
    d["road_block"] = list(d["road_block"])
    d["selected_videos"] = list(d["selected_videos"])
    Path(path).write_text(yaml_dump(d), "utf8")
