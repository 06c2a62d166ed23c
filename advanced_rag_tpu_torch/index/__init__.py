"""Device-resident index layer of the port: corpus store, dense and
sparse indexes, token table and the manager."""
