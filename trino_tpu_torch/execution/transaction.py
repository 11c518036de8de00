"""Transactions: in-memory manager coordinating per-connector handles.

The port of the reference ``execution/transaction.py`` (host only).
Mirrors ``transaction/InMemoryTransactionManager.java:72`` /
``TransactionManager.java:30``: the coordinator tracks a transaction as a
set of per-connector handles; COMMIT/ROLLBACK fan out to every enlisted
connector.  Like the reference, there is no cross-connector two-phase
commit — each connector commits independently (single-connector writes
are the supported atomic unit).

Connector contract (spi/connector.py): ``begin_transaction() -> handle``,
``commit_transaction(handle)``, ``rollback_transaction(handle)``; the
memory connector implements snapshot-based rollback (undoes INSERT/CTAS/
CREATE TABLE since BEGIN).  :func:`handle_transaction_stmt` reports whether
it ran the statement; the runner makes the statement's result, so this
module does not import the runner.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field

from ..sql import ast

__all__ = ["TransactionHandle", "TransactionManager",
           "handle_transaction_stmt"]


@dataclass
class TransactionHandle:
    id: str
    # catalog name -> connector-private handle
    connector_handles: dict = field(default_factory=dict)


class TransactionManager:
    _ids = itertools.count(1)
    _lock = threading.Lock()

    def __init__(self, catalog):
        self.catalog = catalog

    def begin(self) -> TransactionHandle:
        with self._lock:
            return TransactionHandle(f"txn_{next(self._ids)}")

    def enlist(self, txn: TransactionHandle, catalog_name: str) -> None:
        """Open the connector's transaction once per transaction (mirrors
        InMemoryTransactionManager.getTransactionMetadata enlisting)."""
        if catalog_name in txn.connector_handles:
            return
        conn = self.catalog.connector(catalog_name)
        txn.connector_handles[catalog_name] = conn.begin_transaction()

    def commit(self, txn: TransactionHandle) -> None:
        for cat, handle in txn.connector_handles.items():
            self.catalog.connector(cat).commit_transaction(handle)
        txn.connector_handles.clear()

    def rollback(self, txn: TransactionHandle) -> None:
        for cat, handle in txn.connector_handles.items():
            self.catalog.connector(cat).rollback_transaction(handle)
        txn.connector_handles.clear()
        # rollback can undo CREATE TABLE / CTAS: plans made since BEGIN may
        # reference tables that no longer exist
        self.catalog.bump_generation()


def handle_transaction_stmt(stmt, session, catalog) -> bool:
    """START TRANSACTION / COMMIT / ROLLBACK statement dispatch (the
    TransactionControl DataDefinitionTasks).  Returns True when ``stmt``
    was transaction control (and ran), False otherwise."""
    if isinstance(stmt, ast.StartTransaction):
        if session.transaction is not None:
            raise ValueError("transaction already in progress")
        tm = TransactionManager(catalog)
        txn = tm.begin()
        # every known catalog enlists up front: writes through any connector
        # are then covered without per-statement bookkeeping
        for cat_name in catalog.names():
            tm.enlist(txn, cat_name)
        session.transaction = txn
        session._transaction_manager = tm
        return True
    if isinstance(stmt, (ast.Commit, ast.Rollback)):
        txn = session.transaction
        if txn is None:
            raise ValueError("no transaction in progress")
        if isinstance(stmt, ast.Commit):
            session._transaction_manager.commit(txn)
        else:
            session._transaction_manager.rollback(txn)
        session.transaction = None
        return True
    return False
