"""Synthetic weather.csv generator.

The reference repo ships no data (``data/`` is git-ignored, .gitignore:36-39);
its pipeline expects a user-provided ``data/raw/weather.csv`` with columns
Temperature, Humidity, Wind_Speed, Cloud_Cover, Pressure and a string label
``Rain`` in {"rain", "no rain"} (jobs/preprocess.py:23-29). This module
produces a schema-compatible CSV with a learnable (linearly separable-ish)
rain signal so tests and benchmarks can exercise the full ETL->train->deploy
path hermetically.
"""

from __future__ import annotations

import os

import numpy as np

FEATURE_COLUMNS = ["Temperature", "Humidity", "Wind_Speed", "Cloud_Cover", "Pressure"]
LABEL_COLUMN = "Rain"


def _ar1(rng, rows: int, mu: float, sigma: float, phi: float = 0.85):
    """Stationary AR(1) series: mean ``mu``, std ``sigma``, autocorrelation
    ``phi`` — weather-like temporal persistence, so sequence models can
    actually forecast the next step (i.i.d. rows would make the windowed
    task coin-flip by construction)."""
    eps = rng.normal(0.0, sigma * np.sqrt(1.0 - phi * phi), rows)
    x = np.empty(rows)
    x[0] = rng.normal(mu, sigma)
    for t in range(1, rows):
        x[t] = mu + phi * (x[t - 1] - mu) + eps[t]
    return x


def generate_weather_csv(path: str, *, rows: int = 2500, seed: int = 0) -> str:
    """Write a synthetic weather.csv; returns the path."""
    rng = np.random.default_rng(seed)
    temperature = _ar1(rng, rows, 18.0, 8.0)
    humidity = np.clip(_ar1(rng, rows, 60.0, 20.0), 0, 100)
    wind = np.abs(_ar1(rng, rows, 12.0, 6.0))
    cloud = np.clip(_ar1(rng, rows, 50.0, 25.0), 0, 100)
    pressure = _ar1(rng, rows, 1013.0, 8.0)

    # Rain correlates with humidity + cloud cover - pressure anomaly.
    logit = (
        0.06 * (humidity - 60.0)
        + 0.05 * (cloud - 50.0)
        - 0.08 * (pressure - 1013.0)
        + rng.normal(0.0, 0.8, rows)
    )
    rain = np.where(logit > 0.0, "rain", "no rain")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = [temperature, humidity, wind, cloud, pressure]
    with open(path, "w") as f:
        f.write(",".join(FEATURE_COLUMNS + [LABEL_COLUMN]) + "\n")
        for i in range(rows):
            vals = ",".join(f"{c[i]:.4f}" for c in cols)
            f.write(f"{vals},{rain[i]}\n")
    return path


def append_weather_rows(path: str, *, rows: int, seed: int) -> str:
    """Append freshly-generated rows (same schema/distribution) to an
    existing weather CSV — the always-on loop's staging-path growth
    pattern (docs/CONTINUOUS.md). The payload is complete lines written
    in ONE ``write`` call and every generated file ends in a newline,
    so the incremental ETL's append-only digest check holds and a
    concurrent poll can at worst observe a clean prefix. Returns the
    path."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        extra = os.path.join(td, "extra.csv")
        generate_weather_csv(extra, rows=rows, seed=seed)
        with open(extra) as f:
            payload = "".join(f.readlines()[1:])  # drop the header
    with open(path, "a") as f:
        f.write(payload)
    return path
