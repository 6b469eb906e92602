"""Logical type system for the engine.

Device representation (static shapes everywhere):

  INTEGER / BIGINT   int32 / int64
  DECIMAL(w, s)      int64 scaled by 10**s (exact fixed point; the reference
                     uses the same cents representation for TPC-H money,
                     cf. reference dbgen "PENNIES" scaling)
  DATE               int32 unix epoch days
  DOUBLE             float64 (used for averages and final projections)
  BOOLEAN            bool_
  VARCHAR            int32 codes into a per-column *sorted* dictionary.
                     Sorted dictionaries make <, <=, LIKE-prefix etc.
                     order-preserving so string comparisons run on the
                     device as integer code comparisons.
  CHAR1              uint8 (single-character flags, e.g. l_returnflag)

This replaces the reference's Vector/ValidityMask/SelectionVector core
(reference src/common/types/vector.cpp, validity_mask.hpp): a column batch is
a fixed-shape jnp array plus a boolean validity mask; selection vectors become
masks, with explicit compaction kernels where density makes gathering cheaper.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum

import numpy as np


class TypeId(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    DECIMAL = "decimal"
    DATE = "date"
    DOUBLE = "double"
    BOOL = "bool"
    VARCHAR = "varchar"
    CHAR1 = "char1"


@dataclasses.dataclass(frozen=True)
class DataType:
    id: TypeId
    scale: int = 0  # decimal scale (digits after the point)

    @property
    def np_dtype(self):
        return {
            TypeId.INT32: np.int32,
            TypeId.INT64: np.int64,
            TypeId.DECIMAL: np.int64,
            TypeId.DATE: np.int32,
            TypeId.DOUBLE: np.float64,
            TypeId.BOOL: np.bool_,
            TypeId.VARCHAR: np.int32,
            TypeId.CHAR1: np.uint8,
        }[self.id]

    @property
    def is_numeric(self) -> bool:
        return self.id in (TypeId.INT32, TypeId.INT64, TypeId.DECIMAL, TypeId.DOUBLE)

    def __repr__(self):
        if self.id == TypeId.DECIMAL:
            return f"DECIMAL(s={self.scale})"
        return self.id.name


INT32 = DataType(TypeId.INT32)
INT64 = DataType(TypeId.INT64)
DATE = DataType(TypeId.DATE)
DOUBLE = DataType(TypeId.DOUBLE)
BOOL = DataType(TypeId.BOOL)
VARCHAR = DataType(TypeId.VARCHAR)
CHAR1 = DataType(TypeId.CHAR1)


def DECIMAL(scale: int = 2) -> DataType:
    return DataType(TypeId.DECIMAL, scale)


_EPOCH = datetime.date(1970, 1, 1)


def date_to_days(s: str | datetime.date) -> int:
    """'1994-01-01' -> unix epoch days (device DATE representation)."""
    if isinstance(s, str):
        s = datetime.date.fromisoformat(s)
    return (s - _EPOCH).days


def days_to_date(d: int) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(d))


def decimal_to_int(value: float | str, scale: int) -> int:
    """Exact literal conversion: '0.05' with scale 2 -> 5."""
    from decimal import Decimal

    q = Decimal(str(value)) * (10**scale)
    if q != q.to_integral_value():
        raise ValueError(f"literal {value} not representable at scale {scale}")
    return int(q)
