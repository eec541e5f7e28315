"""Closed loops: ``clients`` clients, each starting its next unit as its last
returns, until ``seconds`` have passed; each finishes the unit it is in.
Client 0 runs on the calling thread, the others on threads of their own,
all sharing the one program."""

import threading
import time


def run(step, clients: int, seconds: float, params: dict) -> list:
    """``step(client, k)`` runs a client's k-th unit and returns its record;
    a record with an error stops that client. Returns every record."""
    records: list = []
    lock = threading.Lock()
    deadline = time.perf_counter() + seconds

    def client(c: int) -> None:
        k = 0
        while time.perf_counter() < deadline:
            rec = step(c, k)
            with lock:
                records.append(rec)
            if rec.error is not None:
                return
            k += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(1, clients)]
    for t in threads:
        t.start()
    client(0)
    for t in threads:
        t.join()
    return records
