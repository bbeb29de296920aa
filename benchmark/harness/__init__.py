"""The benchmark's measurement: cells, timed entries, the closed loop,
the device trace, the rooflines and the comparison that decides
`correct`."""
