"""One module per kind of traffic, found by the ``driver`` of a traffic file.

Each module defines ``Driver(config, traffic, seed, device, spans)`` with:

* ``setup()``: the system under test, its weights and inputs from the seed,
  and a warm-up of every shape the window uses;
* ``window(seconds) -> {"metrics": {...}, "attempted": n, "notes": [...]}``:
  the timed window and its end-to-end numbers;
* ``counters``: what the window counted, for the per-layer metrics;
* ``release()``: frees the program's state once the window has closed;
* ``check() -> ({name: (value, limit)}, failed)``: what the window produced,
  compared with the plain reference, each number beside its limit (from the
  traffic file's ``limits``), and the count of answers that were wrong or
  never came.

``spans(name)`` opens a harness span around a call into the program (a no-op
unless the run is traced).
"""
