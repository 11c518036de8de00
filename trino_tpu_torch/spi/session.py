"""Resource-group selectors: which group a session's queries land in.

The port of the reference ``spi/session.py`` (host-only, copied so the
port imports nothing of the reference): the miniature of Trino's
resource-group selector rules (spi/resourcegroups/SelectionCriteria.java
+ db/file selector configs):
each rule optionally matches the session ``user``, the session ``source``
(client-declared workload tag, e.g. ``etl`` vs ``dashboard``) and the SQL
text by regex; the first matching rule names the dotted group path under
the root.  A rule with no match fields is a catch-all.

Rules arrive either programmatically or as the ``selectors`` list inside
the ``TRINO_TPU_RESOURCE_GROUPS`` JSON
(execution/resource_manager.py ``build_group_tree``)::

    {"selectors": [
        {"source": "etl.*",  "group": "batch"},
        {"user": "admin",    "group": "admin"},
        {"group": "adhoc"}]}
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

__all__ = ["SelectorRule", "GroupSelector"]


@dataclass(frozen=True)
class SelectorRule:
    """One selector: regexes are full-match (anchored), like the
    reference's ``userRegex``/``sourceRegex``."""

    group: str
    user: Optional[str] = None
    source: Optional[str] = None
    sql: Optional[str] = None

    def matches(self, sql: str, session) -> bool:
        if self.user is not None and not re.fullmatch(
                self.user, getattr(session, "user", "") or ""):
            return False
        if self.source is not None and not re.fullmatch(
                self.source, getattr(session, "source", "") or ""):
            return False
        if self.sql is not None and not re.search(self.sql, sql or ""):
            return False
        return True


class GroupSelector:
    """First-match-wins rule list; ``select`` returns the dotted group path
    ('' = root) and plugs straight into DispatchManager's selector hook."""

    def __init__(self, rules: list[SelectorRule]):
        self.rules = list(rules)

    @classmethod
    def from_spec(cls, spec: list[dict]) -> "GroupSelector":
        rules = []
        for d in spec:
            if "group" not in d:
                raise ValueError(f"selector rule without 'group': {d!r}")
            rules.append(SelectorRule(
                group=d["group"], user=d.get("user"),
                source=d.get("source"), sql=d.get("sql")))
        return cls(rules)

    def select(self, sql: str, session) -> str:
        for rule in self.rules:
            if rule.matches(sql, session):
                return rule.group
        return ""
