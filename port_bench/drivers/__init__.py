"""One driver per kind of traffic: `synth` (offline batches), `train` (training steps), `serve` (open-loop requests).

A driver module holds a `Session(cell)`: its constructor is the set-up
(weights, the program, warming every shape the cell's traffic reaches);
`window(seconds)` runs the measured window and returns {"e2e", "attempted",
"failed", "record"}; `traced()` runs a profiled stretch of the same traffic
and returns what `record.profile` gives plus the stretch's work; `release()`
frees the program's state; `check(ops)` compares what the window produced
with the reference at precision `ops` and returns {number: value}.
"""
