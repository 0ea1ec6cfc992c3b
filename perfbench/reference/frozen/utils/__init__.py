"""Host helpers: constants, SE(3) math, experiment logging."""
