"""The open loop's load generator, run as a child process of its own (so
its interpreter lock is not the server's): stdlib only.

Reads one JSON line (host, port, bodies, send offsets in seconds, the
indices whose response bodies to keep, threads, drain seconds), prints
"ready", waits for a line on stdin, then sends request i at t0 +
offsets[i] from a pool of threads, each on a new connection (the server
speaks HTTP/1.0). A request is timed from when it was due to the last
byte of its response. Prints one JSON line: per request [lateness s,
latency s, status], and the kept bodies."""

import http.client
import itertools
import json
import sys
import threading
import time


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    bodies = [json.dumps(b).encode() for b in spec["bodies"]]
    offsets = spec["offsets"]
    keep = set(spec["keep"])
    host, port, drain = spec["host"], spec["port"], spec["drain_s"]
    n = len(bodies)
    out = [None] * n
    kept = {}
    lock = threading.Lock()
    counter = itertools.count()
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.monotonic()
    deadline = t0 + offsets[-1] + drain if n else t0

    def worker():
        while True:
            i = next(counter)
            if i >= n:
                return
            due = t0 + offsets[i]
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            sent = time.monotonic()
            status, data = -1, b""
            try:
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=max(1.0, deadline - sent))
                conn.request("POST", "/search", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                conn.close()
            except Exception:  # noqa: BLE001 - a request that fails is counted as failed
                status = -1
            done = time.monotonic()
            out[i] = [sent - due, done - due, status]
            if i in keep:
                with lock:
                    kept[i] = data.decode("utf-8", "replace")

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(spec["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, deadline + 5 - time.monotonic()))
    out = [r if r is not None else [0.0, float(drain + offsets[-1]), -2] for r in out]
    with lock:
        kept = dict(kept)
    sys.stdout.write(json.dumps({"requests": out, "kept": kept}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
