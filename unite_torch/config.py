"""Config system: argparse schema + YAML config + dataset-mapping indirection
(a copy of unite_tpu/config.py; PyYAML is imported only where a YAML file
is read or written).

Reproduces the reference's resolution order (its run_stage1.py:237-270):

1. argparse defines the schema and defaults;
2. ``--config file.yaml`` loads YAML values over the defaults;
3. ``--dataset <name>`` injects annotation paths / nb_classes / student_init
   from ``dataset_mappings.yaml``;
4. CLI flags override everything (the reference re-parses with
   ``namespace=yaml_args`` so explicitly-passed flags win — including after
   the dataset-mapping injection, mirroring run_stage3.py:286-287).

Also replaces the reference's *interactive* experiment-dir overwrite prompt
(utils.py:903-922) with an explicit ``--overwrite`` policy flag.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List, Optional


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def load_yaml(path: str) -> dict:
    import yaml  # only where a YAML file is read

    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_dataset_mapping(args: argparse.Namespace, mappings_path: str) -> None:
    """Inject per-domain-shift settings from dataset_mappings.yaml.

    Mirrors the reference's run_stage1.py:252-270: keys under the named shift
    are written directly onto the namespace (annotation paths, nb_classes,
    optional student_init / ckpt paths).
    """
    name = getattr(args, "dataset", None)
    if not name:
        return
    mappings = load_yaml(mappings_path)
    if name not in mappings:
        raise KeyError(
            f"dataset {name!r} not found in {mappings_path}; "
            f"available: {sorted(mappings)}"
        )
    for k, v in mappings[name].items():
        setattr(args, k, v)


def _coerce_yaml(action, key, value, cfg_path):
    """Run a YAML value through the flag's argparse type + choices check.

    YAML bypasses argparse entirely, so without this a YAML-1.1 scalar like
    ``lr: 1e-3`` (a STRING — no dot in the mantissa) survives until it
    crashes deep in schedule math with no pointer to the config key, and a
    bad ``choices`` value is never rejected. Only string values are
    coerced (YAML already delivered typed ints/floats/bools/lists); list
    values coerce per element for nargs flags."""
    if action is None:
        return value

    def one(v):
        return (action.type(v)
                if action.type is not None and isinstance(v, str) else v)

    try:
        out = [one(v) for v in value] if isinstance(value, list) else one(value)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{cfg_path}: key {key!r}: cannot convert {value!r} via "
            f"{getattr(action.type, '__name__', action.type)}: {e}") from e
    if action.choices is not None:
        vals = out if isinstance(out, list) else [out]
        for v in vals:
            if v not in action.choices:
                raise ValueError(
                    f"{cfg_path}: key {key!r}: {v!r} not in "
                    f"{sorted(action.choices)}")
    return out


def parse_with_config(
    parser: argparse.ArgumentParser,
    argv: Optional[List[str]] = None,
    dataset_mappings: Optional[str] = None,
) -> argparse.Namespace:
    """Three-phase parse with CLI-wins semantics (see module docstring)."""
    # Phase 1: plain parse to discover --config / --dataset.
    first = parser.parse_args(argv)

    ns = argparse.Namespace(**vars(first))

    # Phase 2: YAML over defaults.
    cfg_path = getattr(first, "config", None)
    if cfg_path:
        yaml_vals = load_yaml(cfg_path)
        known = set(vars(first))
        types = {a.dest: a for a in parser._actions}
        for k, v in yaml_vals.items():
            if k in known:
                setattr(ns, k, _coerce_yaml(types.get(k), k, v, cfg_path))
        # CLI re-parse so explicitly-passed flags beat YAML.
        ns = parser.parse_args(argv, namespace=ns)

    # Phase 3: dataset-mapping injection, then CLI re-applied once more
    # (reference applies CLI twice in stage 3, run_stage3.py:286-287).
    mp = dataset_mappings or getattr(ns, "dataset_mappings", None)
    if getattr(ns, "dataset", None) and mp:
        apply_dataset_mapping(ns, mp)
        ns = parser.parse_args(argv, namespace=ns)

    return ns


def dump_config(args: argparse.Namespace, output_dir: str) -> None:
    """Persist the resolved config to the experiment dir (run_stage1.py:626-628).

    YAML where PyYAML is installed; otherwise the same mapping as JSON, which
    a YAML reader also reads."""
    os.makedirs(output_dir, exist_ok=True)
    safe = {
        k: v
        for k, v in vars(args).items()
        if isinstance(v, (bool, int, float, str, list, tuple, type(None)))
    }
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        try:
            import yaml
        except ImportError:
            json.dump(safe, f, indent=1, sort_keys=True)
        else:
            yaml.safe_dump(safe, f, default_flow_style=False, sort_keys=True)


def prepare_output_dir(output_dir: str, overwrite: str = "allow") -> Path:
    """Create the experiment directory with a non-interactive collision policy.

    ``overwrite``: 'allow' (default), 'error', or 'resume'. Replaces the
    reference's interactive rank-0 prompt (utils.py:903-922).
    """
    p = Path(output_dir)
    if p.exists() and any(p.iterdir()):
        if overwrite == "error":
            raise FileExistsError(
                f"output dir {output_dir} exists and is non-empty "
                "(pass --overwrite allow|resume)"
            )
    p.mkdir(parents=True, exist_ok=True)
    return p


def log_stats(stats: dict, output_dir: str, filename: str = "log.txt") -> None:
    """Append one JSON line of epoch stats (reference run_stage1.py:894-898)."""
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(stats) + "\n")

