"""Event listener SPI: query lifecycle events to external sinks.

The port of the reference ``spi/eventlistener.py`` (whole), which mirrors
``spi/eventlistener/EventListener.java:16`` (QueryCreatedEvent /
QueryCompletedEvent dispatched by the coordinator; plugins ship them to
HTTP/Kafka/MySQL sinks).  Listeners here are python objects registered on a
runner; exceptions in a listener never fail the query (reference
behavior)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["QueryCreatedEvent", "QueryCompletedEvent", "EventListener",
           "EventListenerManager"]


@dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str = ""
    create_time: float = field(default_factory=time.time)


@dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    state: str = "FINISHED"  # FINISHED | FAILED
    user: str = ""
    wall_ms: float = 0.0
    output_rows: int = -1
    error: Optional[str] = None
    # final QueryStats roll-up (the reference ships cpu/wall/peak-memory/
    # input counts in its QueryCompletedEvent statistics block): process CPU
    # over the query window, device allocator peak, scanned input, and the
    # retry_policy=QUERY attempt count
    cpu_ms: float = 0.0
    peak_memory_bytes: int = 0
    input_rows: int = 0
    input_bytes: int = 0
    retry_count: int = 0
    # admission + speculation + failure classification (the journal
    # round-trips them): queue wait, the resource group the query
    # ran under, speculative twins that won its task races, and the
    # spi/errors.py error-code name for FAILED queries
    queued_time_ms: float = 0.0
    resource_group: str = ""
    speculative_wins: int = 0
    error_code: Optional[str] = None
    end_time: float = field(default_factory=time.time)


class EventListener:
    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass


class EventListenerManager:
    def __init__(self):
        self._listeners: list[EventListener] = []

    def add(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def query_created(self, event: QueryCreatedEvent) -> None:
        for l in self._listeners:
            try:
                l.query_created(event)
            except Exception:  # noqa: BLE001 — listeners never fail queries
                pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        for l in self._listeners:
            try:
                l.query_completed(event)
            except Exception:  # noqa: BLE001
                pass
