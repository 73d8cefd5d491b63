"""Supported dataset catalog with license/policy identifiers.

Counterpart of ``ser_tpu/_internal/data/catalog.py``: the same catalog, so consents and manifests recorded by either package hold in the other.

Parity surface: reference ``ser/_internal/data/dataset_prepare.py:89-200`` +
``catalog/public_datasets.py`` — the same 16 dataset identifiers with their
policy/license ids and per-corpus label conventions.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DatasetSpec:
    """One supported dataset's identity and compliance metadata.

    ``policy_id``/``license_id``/``display_name``/``source_url``/
    ``requires_manual_download`` are the reference's exact values
    (``dataset_prepare.py:89-218`` SUPPORTED_DATASETS) — they persist into
    manifests and consent stores, so a consent recorded under the reference
    keys must keep working here. ``provider``/``languages`` are this repo's
    acquisition/recipe metadata.
    """

    dataset_id: str
    display_name: str
    provider: str
    policy_id: str
    license_id: str
    languages: tuple[str, ...]
    source_url: str = ""
    requires_manual_download: bool = False
    requires_consent: bool = True


_SPECS: tuple[DatasetSpec, ...] = (
    DatasetSpec(
        "ravdess", "RAVDESS", "zenodo", "noncommercial", "cc-by-nc-sa-4.0", ("en",),
        source_url="https://zenodo.org/records/1188976",
    ),
    DatasetSpec(
        "crema-d", "CREMA-D", "github-lfs", "share_alike", "odbl-1.0", ("en",),
        source_url="https://github.com/CheyneyComputerScience/CREMA-D",
    ),
    DatasetSpec(
        "msp-podcast", "MSP-Podcast", "msp-mirror", "academic_only",
        "msp-academic-license", ("en",),
        source_url="https://huggingface.co/datasets/AbstractTTS/PODCAST",
    ),
    DatasetSpec(
        "biic-podcast", "BIIC-Podcast", "provider", "academic_only",
        "biic-academic-license", ("zh",),
        source_url="https://biic.ee.nthu.edu.tw/",
        requires_manual_download=True,
    ),
    DatasetSpec(
        "emodb-2.0", "EmoDB 2.0", "provider", "open", "cc-by-4.0", ("de",),
        source_url="https://zenodo.org/records/17651657",
    ),
    DatasetSpec(
        "escorpus-pe", "ESCorpus-PE", "provider", "open", "cc-by-4.0", ("es",),
        source_url="https://zenodo.org/records/5793223",
    ),
    DatasetSpec(
        "mesd", "MESD", "mendeley", "open", "cc-by-4.0", ("es",),
        source_url="https://data.mendeley.com/datasets/cy34mh68j9/5",
    ),
    DatasetSpec(
        "oreau-french-esd", "Oreau French ESD", "provider", "open", "cc-by-4.0", ("fr",),
        source_url="https://zenodo.org/records/4405783",
    ),
    DatasetSpec(
        "jl-corpus", "JL-Corpus", "provider", "open", "cc0-1.0", ("en",),
        source_url="https://www.kaggle.com/datasets/tli725/jl-corpus",
    ),
    DatasetSpec(
        "cafe", "CaFE", "provider", "noncommercial", "cc-by-nc-sa-4.0", ("fr",),
        source_url="https://zenodo.org/records/1478765",
    ),
    DatasetSpec(
        "asvp-esd", "ASVP-ESD", "provider", "open", "cc-by-4.0", ("mixed",),
        source_url="https://zenodo.org/records/7132783",
    ),
    DatasetSpec(
        "emov-db", "EmoV-DB", "openslr", "noncommercial", "custom-noncommercial", ("en",),
        source_url="https://www.openslr.org/115/",
    ),
    DatasetSpec(
        "pavoque", "PAVOQUE", "openslr", "noncommercial", "cc-by-nc-sa-4.0", ("de",),
        source_url="https://github.com/marytts/pavoque-data/releases",
    ),
    DatasetSpec(
        "att-hack", "Att-HACK", "provider", "noncommercial", "cc-by-nc-nd-4.0", ("fr",),
        source_url="https://www.openslr.org/88/",
    ),
    DatasetSpec(
        "coraa-ser", "CORAA SER", "provider", "research_only", "custom-research-only", ("pt",),
        source_url="https://github.com/rmarcacini/ser-coraa-pt-br",
    ),
    DatasetSpec(
        "spanish-meacorpus-2023", "Spanish MEACorpus 2023", "provider",
        "noncommercial", "cc-by-nc-4.0", ("es",),
        source_url="https://zenodo.org/records/18606423",
    ),
)

DATASET_CATALOG: dict[str, DatasetSpec] = {spec.dataset_id: spec for spec in _SPECS}


def list_dataset_ids() -> tuple[str, ...]:
    """All supported dataset identifiers in deterministic order."""
    return tuple(sorted(DATASET_CATALOG))


def get_dataset_spec(dataset_id: str) -> DatasetSpec:
    """Returns one dataset spec or raises ``KeyError`` with guidance."""
    try:
        return DATASET_CATALOG[dataset_id]
    except KeyError as err:
        raise KeyError(
            f"Unknown dataset {dataset_id!r}. Supported: {', '.join(list_dataset_ids())}."
        ) from err


__all__ = ["DATASET_CATALOG", "DatasetSpec", "get_dataset_spec", "list_dataset_ids"]
