from repro_torch.sweep.cli import main

raise SystemExit(main())
