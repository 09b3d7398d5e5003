"""Byzantine core of the port: tree helpers, SafeguardSGD, the Defense
protocol and the attacks ported so far."""
