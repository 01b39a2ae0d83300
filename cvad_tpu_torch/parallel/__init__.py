"""Multi-device training and scoring: the port's collectives
(`collectives`), temporal sharding of family D's clips (`temporal`) and a
dry run over gloo CPU processes (`dryrun`)."""
