"""The drivers of the program, one module a kind of traffic, found by the
traffic file's `entry`. Each defines `Entry(config, traffic, seed,
device)`: its set-up makes the pool from the seed and builds the program's
object; `warm()`, `unit(i)` (one closed-loop request, ending with the
client's fetch of its result), `failed()`, `end_to_end(window_s,
latencies, units)`, `summary()`, `release()` (frees the program's state),
`check()` (the numbers compared with the plain reference) and `control()`
(the same numbers with the reference in a lower precision put in the
program's place)."""
