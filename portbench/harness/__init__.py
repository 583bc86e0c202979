"""The benchmark's harness: files found by name (`spec`), the traffic
generator (`traffic`), window arithmetic (`window`), the yardstick's counts
(`counts`), the trace reduction (`trace`), the correctness comparison
(`check`), the import rule (`guard`) and the system under test
(`program`)."""
