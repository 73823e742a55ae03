"""uint16 probability / correspondence-cost codec + Bayesian update tables
(torch port of visfs_tpu.map2d.probability_values, its own copy).

Exact functional parity with the reference codec
(corelib/include/Map/ProbabilityValues.h, src/Map/ProbabilityValues.cpp):
value 0 = unknown, [1, 32767] maps linearly onto [0.1, 0.9]; the update
marker bit (1 << 15) tags cells already updated in the current sweep; odds
updates are precomputed 32768-entry lookup tables.

The tables are built in numpy (float64, as the reference builds them) and
go to the device as int32 (update tables, whose uint16 values the grids
hold as int32, see map2d/grid2d.py) or float32 (the cost table).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

K_VALUE_COUNT = 32768
UNKNOWN_VALUE = 0
UPDATE_MARKER = 1 << 15

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY
MIN_CORRESPONDENCE_COST = 1.0 - MAX_PROBABILITY
MAX_CORRESPONDENCE_COST = 1.0 - MIN_PROBABILITY


def odds(probability):
    return probability / (1.0 - probability)


def probability_from_odds(o):
    return o / (o + 1.0)


def probability_to_correspondence_cost(p):
    return 1.0 - p


def correspondence_cost_to_probability(c):
    return 1.0 - c


def clamp_probability(p):
    return np.clip(p, MIN_PROBABILITY, MAX_PROBABILITY)


def clamp_correspondence_cost(c):
    return np.clip(c, MIN_CORRESPONDENCE_COST, MAX_CORRESPONDENCE_COST)


def _bounded_double_to_value(v, lower, upper):
    """lround((clamp(v) - lower) * 32766/(upper-lower)) + 1."""
    return (
        np.rint((np.clip(v, lower, upper) - lower)
                * (32766.0 / (upper - lower)))
        .astype(np.int64) + 1
    )


def probability_to_value(p):
    return _bounded_double_to_value(p, MIN_PROBABILITY, MAX_PROBABILITY)


def correspondence_cost_to_value(c):
    return _bounded_double_to_value(
        c, MIN_CORRESPONDENCE_COST, MAX_CORRESPONDENCE_COST
    )


def _value_to_bounded_double_table(unknown_value, unknown_result, lower,
                                   upper):
    """[2 * 32768] table (repeated so marker-tagged values also convert)."""
    values = np.arange(K_VALUE_COUNT, dtype=np.float64)
    scale = (upper - lower) / (K_VALUE_COUNT - 2.0)
    table = values * scale + (lower - scale)
    table[unknown_value] = unknown_result
    return np.tile(table, 2)


@lru_cache(maxsize=None)
def value_to_probability_table():
    return _value_to_bounded_double_table(
        UNKNOWN_VALUE, MIN_PROBABILITY, MIN_PROBABILITY, MAX_PROBABILITY
    )


@lru_cache(maxsize=None)
def value_to_correspondence_cost_table():
    return _value_to_bounded_double_table(
        UNKNOWN_VALUE, MAX_CORRESPONDENCE_COST,
        MIN_CORRESPONDENCE_COST, MAX_CORRESPONDENCE_COST,
    )


def value_to_probability(value):
    return value_to_probability_table()[np.asarray(value, dtype=np.int64)]


def value_to_correspondence_cost(value):
    return value_to_correspondence_cost_table()[
        np.asarray(value, dtype=np.int64)
    ]


@lru_cache(maxsize=None)
def compute_lookup_table_to_apply_odds(o: float) -> np.ndarray:
    """probability-value update table
    (ProbabilityValues.cpp:computeLookupTableToApplyOdds)."""
    table = np.empty(K_VALUE_COUNT, dtype=np.uint16)
    table[0] = probability_to_value(probability_from_odds(o)) + UPDATE_MARKER
    probs = value_to_probability_table()[1:K_VALUE_COUNT]
    table[1:] = (
        probability_to_value(probability_from_odds(o * odds(probs)))
        + UPDATE_MARKER
    ).astype(np.uint16)
    return table


@lru_cache(maxsize=None)
def compute_lookup_table_to_apply_correspondence_cost_odds(
        o: float) -> np.ndarray:
    """correspondence-cost update table (ProbabilityValues.cpp:354-362)."""
    table = np.empty(K_VALUE_COUNT, dtype=np.uint16)
    table[0] = (
        correspondence_cost_to_value(
            probability_to_correspondence_cost(probability_from_odds(o))
        )
        + UPDATE_MARKER
    )
    costs = value_to_correspondence_cost_table()[1:K_VALUE_COUNT]
    table[1:] = (
        correspondence_cost_to_value(
            probability_to_correspondence_cost(
                probability_from_odds(
                    o * odds(correspondence_cost_to_probability(costs))
                )
            )
        )
        + UPDATE_MARKER
    ).astype(np.uint16)
    return table


def probability_value_to_correspondence_cost_value(value):
    """Codec cross-conversion incl. marker bit (ProbabilityValues.h:76-89)."""
    value = np.asarray(value, dtype=np.int64)
    carry = value > UPDATE_MARKER
    base = np.where(carry, value - UPDATE_MARKER, value)
    out = correspondence_cost_to_value(
        probability_to_correspondence_cost(value_to_probability(base))
    )
    out = np.where(base == UNKNOWN_VALUE, UNKNOWN_VALUE, out)
    return np.where(carry, out + UPDATE_MARKER, out)


def correspondence_cost_value_to_probability_value(value):
    value = np.asarray(value, dtype=np.int64)
    carry = value > UPDATE_MARKER
    base = np.where(carry, value - UPDATE_MARKER, value)
    out = probability_to_value(
        correspondence_cost_to_probability(value_to_correspondence_cost(base))
    )
    out = np.where(base == UNKNOWN_VALUE, UNKNOWN_VALUE, out)
    return np.where(carry, out + UPDATE_MARKER, out)


def hit_miss_tables(hit_probability: float, miss_probability: float,
                    device="cuda"):
    """Device-side (hit, miss) correspondence-cost update tables, [32768]
    int32 holding the uint16 values."""
    hit = compute_lookup_table_to_apply_correspondence_cost_odds(
        odds(hit_probability)
    )
    miss = compute_lookup_table_to_apply_correspondence_cost_odds(
        odds(miss_probability)
    )
    return (torch.tensor(hit.astype(np.int32), device=device),
            torch.tensor(miss.astype(np.int32), device=device))


def cost_table(device="cuda"):
    """[65536] float32 value -> correspondence cost (marker-tagged values
    included), on ``device``."""
    return torch.tensor(value_to_correspondence_cost_table(),
                        dtype=torch.float32, device=device)
