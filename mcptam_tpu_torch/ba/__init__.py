"""Bundle adjustment: the LM solver, its problems and the map adjusters."""
