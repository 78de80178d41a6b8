"""Entry drivers: one module per entry point of the program that a traffic
mix can name (``"entry"`` in ``traffic/<name>.json``).

Each module defines

  * ``setup(ctx) -> state`` — make the inputs from the seed, build the
    program's objects, warm up every shape the window uses;
  * ``step(state, i) -> dict`` — the window's ``i``-th unit of work, run to
    completion on the host (a chunk or a round): ``dimms`` (the DIMMs it
    completed; 0 where absent), optionally ``counts`` (other units it
    completed by name, such as ``{"tokens": n}``, summed over the window
    into the run's ``counts`` for the metric readers) and the program's
    outputs;
  * ``release(state)`` — drop the program's device state before the check;
  * ``reference_unit(state, unit, dtype) -> dict`` — the plain
    reference's outputs for every DIMM of ``unit``, in the float ``dtype``;
  * ``compare(unit, ref) -> dict`` — the numbers compared, by name;
  * ``kernel_work(state) -> dict`` — the work of one launch of each kernel
    the window drives, by kernel name (``roofline.py``), or ``{}``;

and optionally ``controls(state, unit) -> dict`` — by name, controls that
put the plain reference in the program's place with one guarantee broken,
each an output for ``compare`` (``control.py``; without it the one control
is ``reference_unit`` in bfloat16).
"""
