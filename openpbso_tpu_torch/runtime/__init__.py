"""Block solver, carried state and the host session of the port."""
