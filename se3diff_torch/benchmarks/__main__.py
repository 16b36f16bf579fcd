from se3diff_torch.benchmarks.cli import main

if __name__ == "__main__":
    main()
