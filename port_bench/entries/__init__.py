"""One module an entry of the port that a configuration names (its "entry"
key): `build(config, material, root, device)` -> a Solver with

  build_s             host seconds of the port's build, ended by a sync
  layout              (coords, elems) of the port's mesh, numpy
  request()           one request through the port's entry; no sync
  counts(raw)         {"cg", "newton", "steps", "plastic", "zeta"} of the
                      request
  answer(raw)         {"u", "ep", "zeta", "zeta_hist", "n_steps"} on the
                      host, on the port's layout, for the reference
"""
