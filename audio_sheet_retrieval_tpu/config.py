"""Settings and experiment configuration.

Replaces the reference's hostname-dispatched module constants
(reference:config/settings.py:5-18) with environment variables, and its
experiment YAMLs (reference:exp_configs/*.yaml) with the same key schema
loaded into a dataclass. Tag convention `<split>_<config>` names every
artifact (reference:run_train.py:44-48).

The YAML files this package reads and writes (experiment configs, split
files, result dumps) use one small subset: block mappings and sequences of
scalars, as ``yaml.safe_dump`` writes them. ``parse_yaml``/``dump_yaml``
cover exactly that subset, so no YAML library is needed.
"""

from __future__ import annotations

import dataclasses
import numbers
import os
import re
from typing import Any, Dict, List, Optional, Tuple

EXP_ROOT = os.environ.get(
    "ASR_TPU_EXP_ROOT",
    os.path.join(os.path.expanduser("~"), "experiments", "asr_tpu"))
DATA_ROOT_MSMD = os.environ.get("ASR_TPU_DATA_ROOT_MSMD", "/data/msmd_aug")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
EXP_CONFIG_DIR = os.path.join(os.path.dirname(_PKG_DIR), "exp_configs")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Schema of exp_configs/*.yaml (reference mutopia_full_aug.yaml:1-16)."""

    sheet_context: int = 200
    system_height: int = 160
    spec_context: int = 42
    spec_bins: int = 92
    augment: Dict = dataclasses.field(default_factory=dict)
    test_synth: str = "grand-piano-YDP-20160804"
    test_tempo: float = 1.0
    name: str = "default"


def load_experiment_config(path: Optional[str]) -> ExperimentConfig:
    if path is None:
        from audio_sheet_retrieval_tpu.data.pools import NO_AUGMENT

        return ExperimentConfig(augment=dict(NO_AUGMENT))
    # allow bare names resolved against the shipped exp_configs dir
    if not os.path.exists(path):
        candidate = os.path.join(EXP_CONFIG_DIR, os.path.basename(path))
        if not candidate.endswith(".yaml"):
            candidate += ".yaml"
        if os.path.exists(candidate):
            path = candidate
    raw = read_yaml(path)
    return ExperimentConfig(
        sheet_context=raw["SHEET_CONTEXT"],
        system_height=raw["SYSTEM_HEIGHT"],
        spec_context=raw["SPEC_CONTEXT"],
        spec_bins=raw["SPEC_BINS"],
        augment=dict(raw["AUGMENT"]),
        test_synth=raw["TEST_SYNTH"],
        test_tempo=float(raw["TEST_TEMPO"]),
        name=os.path.splitext(os.path.basename(path))[0],
    )


def load_split(split_file: str) -> Dict[str, List[str]]:
    """{train, valid, test} piece-name lists (reference mutopia_data.py:13-18)."""
    return read_yaml(split_file)


def derive_result_path(param_file: str, prefix: str, suffix: str) -> str:
    """Reference artifact-naming convention, made safe for any checkpoint
    extension: ``.../params_<tag>.pkl -> .../<prefix><tag>_<suffix>``
    (reference run_eval.py:196-212, umc_a2s_server.py:116-118 used string
    replace on '.pkl', which would return the CHECKPOINT path itself — and
    overwrite it on dump — for .npz/orbax parameter files)."""
    d, base = os.path.split(os.path.abspath(param_file))
    stem = os.path.splitext(base)[0]
    if stem.startswith("params_"):
        stem = stem[len("params_"):]
    elif stem == "params":
        stem = ""
    name = prefix + (stem + "_" if stem else "") + suffix
    # never write results into the installed package (vendored-asset
    # checkpoints): results for those go to the current directory
    from audio_sheet_retrieval_tpu.assets import assets_dir

    if os.path.commonpath([d, assets_dir()]) == assets_dir():
        d = os.getcwd()
    return os.path.join(d, name)


def compile_tag(train_split: Optional[str], config: Optional[str]) -> Optional[str]:
    """`<split-stem>_<config-stem>` artifact tag (reference run_train.py:44-48)."""
    if train_split is None and config is None:
        return None
    parts = []
    if train_split is not None:
        parts.append(os.path.splitext(os.path.basename(train_split))[0])
    if config is not None:
        parts.append(os.path.splitext(os.path.basename(config))[0])
    return "_".join(parts)


# ---------------------------------------------------------------------------
# YAML subset: block mappings / sequences of scalars (YAML 1.1 scalars as
# PyYAML resolves them)
# ---------------------------------------------------------------------------

_INT_RE = re.compile(r"[-+]?[0-9]+$")
_FLOAT_RE = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}
_NULLS = ("", "~", "null", "Null", "NULL")


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if t[:1] == "'":
        if len(t) < 2 or t[-1] != "'":
            raise ValueError(f"unterminated quoted scalar: {text!r}")
        return t[1:-1].replace("''", "'")
    if t[:1] == '"':
        if len(t) < 2 or t[-1] != '"':
            raise ValueError(f"unterminated quoted scalar: {text!r}")
        return t[1:-1].encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if t == "[]":
        return []
    if t == "{}":
        return {}
    if t[:1] in "[{":
        raise ValueError(f"flow collections are not supported: {text!r}")
    if t in _NULLS:
        return None
    if t.lower() in _BOOLS and t in (t.lower(), t.title(), t.upper()):
        return _BOOLS[t.lower()]
    if _INT_RE.match(t):
        return int(t)
    if _FLOAT_RE.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    low = t.lower()
    if low in (".inf", "+.inf", "-.inf", ".nan"):
        return float(low.replace(".", ""))
    return t


def _split_key(content: str) -> Tuple[str, str]:
    """'key: rest' -> (key, rest); quoted keys allowed."""
    if content[:1] in ("'", '"'):
        end = content.index(content[0], 1)
        while content[0] == "'" and content[end + 1:end + 2] == "'":
            end = content.index("'", end + 2)
        key, tail = content[:end + 1], content[end + 1:]
        if not tail.startswith(":"):
            raise ValueError(f"expected ':' after key in {content!r}")
        return _parse_scalar(key), tail[1:]
    m = re.search(r":(\s|$)", content)
    if m is None:
        raise ValueError(f"not a 'key: value' line: {content!r}")
    return content[:m.start()].strip(), content[m.end():]


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        stripped = raw.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        lines.append((len(raw) - len(raw.lstrip(" ")), stripped))

    def block(i: int, indent: int) -> Tuple[Any, int]:
        if lines[i][1] == "-" or lines[i][1].startswith("- "):
            seq = []
            while (i < len(lines) and lines[i][0] == indent
                   and (lines[i][1] == "-" or lines[i][1].startswith("- "))):
                seq.append(_parse_scalar(lines[i][1][1:]))
                i += 1
            return seq, i
        mapping = {}
        while i < len(lines) and lines[i][0] == indent:
            key, rest = _split_key(lines[i][1])
            i += 1
            if rest.strip():
                mapping[key] = _parse_scalar(rest)
            elif i < len(lines) and (
                    lines[i][0] > indent
                    or (lines[i][0] == indent
                        and (lines[i][1] == "-"
                             or lines[i][1].startswith("- ")))):
                mapping[key], i = block(i, lines[i][0])
            else:
                mapping[key] = None
        return mapping, i

    if not lines:
        return None
    if len(lines) == 1 and not re.search(r":(\s|$)", lines[0][1]) \
            and not lines[0][1].startswith("- "):
        return _parse_scalar(lines[0][1])
    value, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unsupported YAML structure near {lines[i][1]!r}")
    return value


def _dump_scalar(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, numbers.Integral):
        return str(int(x))
    if isinstance(x, numbers.Real):
        x = float(x)
        if x != x:
            return ".nan"
        if x in (float("inf"), float("-inf")):
            return ".inf" if x > 0 else "-.inf"
        r = repr(x)
        if "e" in r and "." not in r.split("e")[0]:
            r = r.replace("e", ".0e")
        if "e" in r and r.split("e")[1][:1] not in "+-":
            r = r.replace("e", "e+")
        return r
    if isinstance(x, str):
        if "\n" in x:
            raise ValueError("multi-line strings are not supported")
        plain = (x == x.strip() and x and _parse_scalar(x) == x
                 and x[0] not in "-?:,[]{}#&*!|>'\"%@`"
                 and ": " not in x and " #" not in x and not x.endswith(":"))
        return x if plain else "'" + x.replace("'", "''") + "'"
    raise TypeError(f"cannot dump {type(x).__name__} to YAML")


def dump_yaml(obj: Any, indent: int = 0) -> str:
    """Block-style YAML for dicts / lists of scalars (yaml.safe_dump's
    layout: sequence items at their key's indentation)."""
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            key = _dump_scalar(str(k))
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent))
            else:
                out.append(f"{pad}{key}: {_dump_inline(v)}\n")
        return "".join(out)
    if isinstance(obj, (list, tuple)):
        if not obj:
            return pad + "[]\n"
        for v in obj:
            if isinstance(v, (dict, list, tuple)):
                raise TypeError("sequence items must be scalars")
        return "".join(f"{pad}- {_dump_scalar(v)}\n" for v in obj)
    return _dump_scalar(obj) + "\n"


def _dump_inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _dump_scalar(v)


def read_yaml(path: str) -> Any:
    with open(path, encoding="utf-8") as fp:
        return parse_yaml(fp.read())


def write_yaml(path: str, obj: Any) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        fp.write(dump_yaml(obj))
