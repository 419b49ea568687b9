"""The benchmark's yardstick: cells and discovery, scenes, window
statistics, the device trace's reduction and the rooflines."""
