"""Evaluation fixtures: the NYC-taxi schema and query suites.

These reproduce the reference harness's *data* (its behavioral contract, not
its code): the taxi CREATE TABLE system prompt and the NL→SQL pairs scored in
`Model_Evaluation_&_Comparision.py:25-38` (single query) and `:86-103`
(four-query suite) — the same fixtures behind every number in BASELINE.md.

A copy of the JAX package's `evalh/fixtures.py`: the suites are identical.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class EvalCase:
    nl: str
    expected_sql: str


#: Column order of the taxi fixture table (matches TAXI_DDL_SYSTEM).
TAXI_COLUMNS = (
    "VendorID", "tpep_pickup_datetime", "tpep_dropoff_datetime",
    "passenger_count", "trip_distance", "fare_amount", "extra",
    "tip_amount", "tolls_amount", "improvement_surcharge", "total_amount",
)


def write_taxi_fixture_csv(path, rows: int = 64, seed: int = 0) -> str:
    """Deterministic synthetic NYC-taxi CSV matching TAXI_DDL_SYSTEM, so
    execution-match scoring has a table to run the suite's SQL against
    (2 vendors, a passenger_count spread crossing the `> 2` predicate)."""
    import csv
    import random

    rng = random.Random(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TAXI_COLUMNS)
        for i in range(rows):
            fare = round(rng.uniform(4.0, 60.0), 2)
            tip = round(rng.uniform(0.0, 12.0), 2)
            tolls = round(rng.choice([0.0, 0.0, 6.55]), 2)
            w.writerow([
                rng.choice([1, 2]),
                f"2024-01-{(i % 28) + 1:02d} 08:{i % 60:02d}:00",
                f"2024-01-{(i % 28) + 1:02d} 08:{(i + 17) % 60:02d}:00",
                float(rng.choice([1, 1, 2, 3, 4, 5])),
                round(rng.uniform(0.4, 18.0), 2),
                fare,
                0.5,
                tip,
                tolls,
                0.3,
                round(fare + 0.5 + tip + tolls + 0.3, 2),
            ])
    return str(path)


TAXI_DDL_SYSTEM = (
    "Here is the database schema that the SQL query will run on: "
    "CREATE TABLE taxi (VendorID bigint, tpep_pickup_datetime timestamp, "
    "tpep_dropoff_datetime timestamp, passenger_count double, "
    "trip_distance double, fare_amount double, extra double, "
    "tip_amount double, tolls_amount double, improvement_surcharge double, "
    "total_amount double);"
)

SINGLE_COMPLEX_CASE = EvalCase(
    nl=(
        "Provide me with the total fare amount, including tips and tolls, "
        "for each vendor, along with the average trip distance, for trips "
        "that had more than 2 passengers, sorted by total fare amount in "
        "descending order?"
    ),
    expected_sql=(
        "SELECT VendorID, \n"
        "       SUM(total_amount) AS total_fare, \n"
        "       AVG(trip_distance) AS avg_trip_distance\n"
        "FROM taxi\n"
        "WHERE passenger_count > 2\n"
        "GROUP BY VendorID\n"
        "ORDER BY total_fare DESC;"
    ),
)

#: Grammar-breadth suite: NL→SQL pairs whose expected SQL exercises the
#: `[NOT] IN (...)` and `[NOT] BETWEEN lo AND hi` predicates the
#: constrained grammar admits — scored through the SAME harness as
#: FOUR_QUERY_SUITE (grammar validity via the in-tree parser,
#: executability + execution match via the sqlite taxi oracle), so
#: every widened production has an end-to-end number, not just parser
#: unit coverage. Kept separate from FOUR_QUERY_SUITE: that list IS the
#: reference harness's behavioral contract and must not drift.
GRAMMAR_BREADTH_SUITE: List[EvalCase] = [
    EvalCase(
        nl="Get all trips operated by vendor 1 or vendor 2.",
        expected_sql="SELECT * FROM taxi WHERE VendorID IN (1, 2);",
    ),
    EvalCase(
        nl="Count the trips between 1 and 5 miles long.",
        expected_sql=(
            "SELECT COUNT(*) FROM taxi "
            "WHERE trip_distance BETWEEN 1.0 AND 5.0;"
        ),
    ),
    EvalCase(
        nl="Average fare for trips that were not solo rides.",
        expected_sql=(
            "SELECT AVG(fare_amount) FROM taxi "
            "WHERE passenger_count NOT IN (1);"
        ),
    ),
    EvalCase(
        nl="Total fare by vendor excluding fares between 0 and 5 dollars.",
        expected_sql=(
            "SELECT VendorID, SUM(total_amount) AS Total_Fare FROM taxi "
            "WHERE fare_amount NOT BETWEEN 0.0 AND 5.0 GROUP BY VendorID;"
        ),
    ),
]

FOUR_QUERY_SUITE: List[EvalCase] = [
    EvalCase(
        nl="Get all taxis with more than 2 passengers.",
        expected_sql="SELECT * FROM taxi WHERE passenger_count > 2;",
    ),
    EvalCase(
        nl="Show total fare collected by each vendor.",
        expected_sql=(
            "SELECT VendorID, SUM(total_amount) AS Total_Fare FROM taxi "
            "GROUP BY VendorID;"
        ),
    ),
    EvalCase(
        nl="Find the average trip distance for trips that had more than 2 passengers.",
        expected_sql="SELECT AVG(trip_distance) FROM taxi WHERE passenger_count > 2;",
    ),
    EvalCase(
        nl="List all vendors ordered by total fare in descending order.",
        expected_sql=(
            "SELECT VendorID, SUM(total_amount) AS Total_Fare FROM taxi "
            "GROUP BY VendorID ORDER BY Total_Fare DESC;"
        ),
    ),
]
