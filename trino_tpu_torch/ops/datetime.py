"""Calendar math on int "days since 1970-01-01" tensors (the DATE storage).

Howard Hinnant's civil-calendar algorithms as branch-free integer tensor
ops, the port of the reference ``ops/datetime.py``.  Floor division is
``torch.div(..., rounding_mode="floor")``, matching ``jnp.floor_divide``.
"""

from __future__ import annotations

import torch

__all__ = ["civil_from_days", "days_from_civil", "add_months", "year_of",
           "month_of", "day_of", "quarter_of", "day_of_week", "day_of_year",
           "trunc_year", "trunc_quarter", "trunc_month", "trunc_week",
           "MICROS_PER_DAY"]

MICROS_PER_DAY = 86_400_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z):
    """days-since-epoch -> (year, month, day)."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def year_of(days):
    return civil_from_days(days)[0]


def month_of(days):
    return civil_from_days(days)[1]


def day_of(days):
    return civil_from_days(days)[2]


def quarter_of(days):
    return _fdiv(civil_from_days(days)[1] + 2, 3)


def day_of_week(days):
    """ISO day of week: 1 = Monday .. 7 = Sunday (Trino day_of_week/dow).
    1970-01-01 was a Thursday, so (days + 3) mod 7 counts from Monday."""
    return torch.remainder(days.to(torch.int64) + 3, 7) + 1


def day_of_year(days):
    return days.to(torch.int64) - trunc_year(days) + 1


def trunc_year(days):
    y, _, _ = civil_from_days(days)
    one = torch.ones_like(y)
    return days_from_civil(y, one, one)


def trunc_quarter(days):
    y, m, _ = civil_from_days(days)
    qm = _fdiv(m - 1, 3) * 3 + 1
    return days_from_civil(y, qm, torch.ones_like(y))


def trunc_month(days):
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, torch.ones_like(y))


def trunc_week(days):
    """Truncate to the Monday of the week."""
    return days.to(torch.int64) - (day_of_week(days) - 1)


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def add_months(days, n):
    """DATE + INTERVAL n MONTH with end-of-month clamping (SQL semantics)."""
    days = torch.as_tensor(days)
    y, m, d = civil_from_days(days)
    total = y * 12 + (m - 1) + torch.as_tensor(n, device=days.device)
    ny = _fdiv(total, 12)
    nm = torch.remainder(total, 12) + 1
    leap = (((ny % 4 == 0) & (ny % 100 != 0)) | (ny % 400 == 0))
    dim = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int64, device=days.device)
    dmax = dim[nm - 1] + ((nm == 2) & leap).to(torch.int64)
    return days_from_civil(ny, nm, torch.minimum(d, dmax))
