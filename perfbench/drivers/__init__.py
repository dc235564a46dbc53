"""Traffic drivers: the general generators that a traffic mix's data
file names and parameterises."""
