from raytracinggpu.cli.main import main

raise SystemExit(main())
