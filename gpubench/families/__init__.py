"""Model families: one module each, found by a configuration's ``family``
(``spec.family_module``). Each holds the program side of its family:

* ``hyperparameters(cfg)``: the family's fluent ``Hyperparameters`` with its
  own keys applied (``program.build`` adds the keys every family shares);
* ``tower_shapes(cfg)``: ``(path, shape, kind, fans)`` of the tower's leaves
  in the port's tree layout (``weights.tower_leaves`` draws them);
* ``tower_flops(cfg, positions, keys)``: the tower's operations over
  ``positions`` positions, ``keys`` the sum over them of the positions
  attended (``flops.serve_batch`` adds the catalog's scores).

Its plain tower is ``reference/<family>.py``."""
