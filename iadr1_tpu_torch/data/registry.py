"""Dataset registry: dataset_info.json compatibility (the port's own copy
of iadr1_tpu/data/registry.py).

Parses the same registry format the reference uses (data/dataset_info.json,
llamafactory/data/parser.py): name -> file location + formatting
(sharegpt/alpaca) + column/tag mapping.  A user of the reference can point
this framework at their existing dataset_info.json unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Callable


@dataclasses.dataclass
class DatasetAttr:
    name: str
    file_name: str | None = None
    # remote sources (reference data/parser.py load_from hf_hub/ms_hub/
    # om_hub/script): parsed so dataset_info.json files round-trip; loaded
    # through the injectable hub-fetcher registry below
    hf_hub_url: str | None = None
    ms_hub_url: str | None = None
    om_hub_url: str | None = None
    script_url: str | None = None
    subset: str | None = None
    folder: str | None = None
    formatting: str = "alpaca"          # "alpaca" | "sharegpt"
    split: str = "train"
    num_samples: int | None = None
    # column mapping
    messages: str = "conversations"
    images: str | None = None
    videos: str | None = None
    system: str | None = None
    tools: str | None = None
    # alpaca columns
    prompt: str = "instruction"
    query: str = "input"
    response: str = "output"
    history: str | None = None
    # sharegpt tags
    role_tag: str = "from"
    content_tag: str = "value"
    user_tag: str = "human"
    assistant_tag: str = "gpt"
    observation_tag: str = "observation"
    function_tag: str = "function_call"
    system_tag: str = "system"


def load_dataset_registry(path: str | Path) -> dict[str, DatasetAttr]:
    """dataset_info.json -> {name: DatasetAttr}."""
    with open(path) as f:
        info = json.load(f)
    registry: dict[str, DatasetAttr] = {}
    for name, spec in info.items():
        attr = DatasetAttr(name=name, file_name=spec.get("file_name"))
        attr.hf_hub_url = spec.get("hf_hub_url")
        attr.ms_hub_url = spec.get("ms_hub_url")
        attr.om_hub_url = spec.get("om_hub_url")
        attr.script_url = spec.get("script_url")
        attr.subset = spec.get("subset")
        attr.folder = spec.get("folder")
        attr.formatting = spec.get("formatting", "alpaca")
        attr.split = spec.get("split", "train")
        attr.num_samples = spec.get("num_samples")
        columns = spec.get("columns", {})
        for col in ("messages", "images", "videos", "system", "tools",
                    "prompt", "query", "response", "history"):
            if col in columns:
                setattr(attr, col, columns[col])
        tags = spec.get("tags", {})
        for tag in ("role_tag", "content_tag", "user_tag", "assistant_tag",
                    "observation_tag", "function_tag", "system_tag"):
            if tag in tags:
                setattr(attr, tag, tags[tag])
        registry[name] = attr
    return registry


# --- hub fetchers ----------------------------------------------------------
#
# The reference's load_from dispatch (data/loader.py:44-150: hf_hub via
# datasets.load_dataset, ms_hub via modelscope MsDataset, om_hub via
# openmind, script via a loader script) behind an injectable interface:
# tests (and air-gapped deployments) register fake fetchers; live
# environments fall back to the real hub libraries.

HubFetcher = Callable[[DatasetAttr], list]


def _fetch_hf_hub(attr: DatasetAttr) -> list:
    try:
        from datasets import load_dataset  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"dataset {attr.name!r} is hub-backed ({attr.hf_hub_url}) but "
            "the `datasets` library is unavailable; download the data and "
            "point file_name at the local JSON instead"
        ) from e
    ds = load_dataset(attr.hf_hub_url, name=attr.subset,
                      data_dir=attr.folder, split=attr.split)
    return list(ds)


def _fetch_ms_hub(attr: DatasetAttr) -> list:
    try:
        from modelscope import MsDataset  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"dataset {attr.name!r} is ModelScope-hub-backed "
            f"({attr.ms_hub_url}); install `modelscope` or download the "
            "data and set file_name"
        ) from e
    ds = MsDataset.load(attr.ms_hub_url, subset_name=attr.subset,
                        data_dir=attr.folder, split=attr.split)
    return list(ds)


def _fetch_om_hub(attr: DatasetAttr) -> list:
    try:
        from openmind import OmDataset  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"dataset {attr.name!r} is OpenMind-hub-backed "
            f"({attr.om_hub_url}); install `openmind` or download the data "
            "and set file_name"
        ) from e
    ds = OmDataset.load_dataset(attr.om_hub_url, subset_name=attr.subset,
                                data_dir=attr.folder, split=attr.split)
    return list(ds)


def _fetch_script(attr: DatasetAttr) -> list:
    from datasets import load_dataset  # type: ignore

    ds = load_dataset(attr.script_url, name=attr.subset, split=attr.split,
                      trust_remote_code=False)
    return list(ds)


HUB_FETCHERS: dict[str, HubFetcher] = {
    "hf_hub": _fetch_hf_hub,
    "ms_hub": _fetch_ms_hub,
    "om_hub": _fetch_om_hub,
    "script": _fetch_script,
}


def register_hub_fetcher(kind: str, fetcher: HubFetcher) -> HubFetcher:
    """Override a hub backend (returns the previous fetcher)."""
    prev = HUB_FETCHERS.get(kind)
    HUB_FETCHERS[kind] = fetcher
    return prev


def hub_source(attr: DatasetAttr) -> "tuple[str, str] | None":
    """(kind, locator) of the remote source, or None for local files.
    Priority mirrors the reference parser (parser.py load_from)."""
    for kind, url in (("hf_hub", attr.hf_hub_url),
                      ("ms_hub", attr.ms_hub_url),
                      ("om_hub", attr.om_hub_url),
                      ("script", attr.script_url)):
        if url:
            return kind, url
    return None


def load_json_dataset(attr: DatasetAttr, base_dir: str | None = None,
                      hub_fetcher: HubFetcher | None = None) -> list[dict]:
    """Load the rows of a dataset: local json/jsonl, or a hub dataset via
    the fetcher registry (reference data/loader.py:44-150 load_from
    dispatch).  ``hub_fetcher`` overrides the registry for this call."""
    if attr.file_name is None:
        source = hub_source(attr)
        if source is None:
            raise ValueError(
                f"dataset {attr.name!r} has no file_name or hub url"
            )
        fetcher = hub_fetcher or HUB_FETCHERS[source[0]]
        rows = [dict(r) for r in fetcher(attr)]
        if attr.num_samples is not None:
            rows = rows[: attr.num_samples]
        return rows
    path = attr.file_name
    if base_dir and not os.path.isabs(path):
        path = os.path.join(base_dir, path)
    with open(path) as f:
        if path.endswith(".jsonl"):
            rows = [json.loads(line) for line in f if line.strip()]
        else:
            rows = json.load(f)
    if attr.num_samples is not None:
        rows = rows[: attr.num_samples]
    return rows
