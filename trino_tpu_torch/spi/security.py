"""Access control SPI.

The port's copy of the reference ``spi/security.py`` (host only).  Mirrors
``spi/security`` + ``security/AccessControlManager.java:97``: a chain of
AccessControl implementations consulted before metadata and data
operations; the first denial wins.  Ships AllowAll (default), DenyAll, and
a rule-based implementation in the spirit of the file-based access control
plugin (user -> table privileges)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

__all__ = ["AccessDeniedError", "AccessControl", "AllowAllAccessControl",
           "DenyAllAccessControl", "TableRule", "RuleBasedAccessControl",
           "AccessControlManager"]


class AccessDeniedError(Exception):
    pass


class AccessControl:
    def check_can_select(self, user: str, catalog: str, table: str,
                         columns: Iterable[str]) -> None:
        pass

    def check_can_create_table(self, user: str, catalog: str,
                               table: str) -> None:
        pass

    def check_can_drop_table(self, user: str, catalog: str,
                             table: str) -> None:
        pass

    def check_can_insert(self, user: str, catalog: str, table: str) -> None:
        pass

    def check_can_delete(self, user: str, catalog: str, table: str) -> None:
        pass

    def check_can_execute_function(self, user: str, name: str) -> None:
        pass


class AllowAllAccessControl(AccessControl):
    pass


class DenyAllAccessControl(AccessControl):
    def _deny(self, what: str) -> None:
        raise AccessDeniedError(f"Access Denied: {what}")

    def check_can_select(self, user, catalog, table, columns):
        self._deny(f"select from {catalog}.{table}")

    def check_can_create_table(self, user, catalog, table):
        self._deny(f"create table {catalog}.{table}")

    def check_can_drop_table(self, user, catalog, table):
        self._deny(f"drop table {catalog}.{table}")

    def check_can_insert(self, user, catalog, table):
        self._deny(f"insert into {catalog}.{table}")

    def check_can_delete(self, user, catalog, table):
        self._deny(f"delete from {catalog}.{table}")

    def check_can_execute_function(self, user, name):
        self._deny(f"execute function {name}")


@dataclass
class TableRule:
    """One grant: user (or '*') may apply ``privileges`` to catalog.table
    patterns ('*' wildcard suffix supported)."""

    user: str
    catalog: str
    table: str  # exact name or '*'
    privileges: set = field(default_factory=lambda: {"SELECT"})

    def matches(self, user: str, catalog: str, table: str) -> bool:
        return ((self.user in ("*", user))
                and (self.catalog in ("*", catalog))
                and (self.table in ("*", table)))


class RuleBasedAccessControl(AccessControl):
    """First-match-wins table rules (reference:
    plugin/trino-resource-group-managers file-based access control model)."""

    def __init__(self, rules: list[TableRule]):
        self.rules = list(rules)

    def _check(self, priv: str, user: str, catalog: str, table: str) -> None:
        for r in self.rules:
            if r.matches(user, catalog, table):
                if priv in r.privileges or "ALL" in r.privileges:
                    return
                break
        raise AccessDeniedError(
            f"Access Denied: {user} cannot {priv} {catalog}.{table}")

    def check_can_select(self, user, catalog, table, columns):
        self._check("SELECT", user, catalog, table)

    def check_can_create_table(self, user, catalog, table):
        self._check("OWNERSHIP", user, catalog, table)

    def check_can_drop_table(self, user, catalog, table):
        self._check("OWNERSHIP", user, catalog, table)

    def check_can_insert(self, user, catalog, table):
        self._check("INSERT", user, catalog, table)

    def check_can_delete(self, user, catalog, table):
        self._check("DELETE", user, catalog, table)


class AccessControlManager(AccessControl):
    """Chain; every element must allow (reference:
    security/AccessControlManager checks system then connector controls)."""

    def __init__(self, controls: Optional[list] = None):
        self.controls = list(controls or [AllowAllAccessControl()])

    def add(self, control: AccessControl) -> None:
        self.controls.append(control)

    def __getattribute__(self, name):
        if name.startswith("check_can_"):
            controls = object.__getattribute__(self, "controls")

            def chain(*args, **kwargs):
                for c in controls:
                    getattr(c, name)(*args, **kwargs)

            return chain
        return object.__getattribute__(self, name)
